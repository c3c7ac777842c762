"""mfas_tpu_torch/bench.py, the port's benchmark harness, on the CPU.

The output contract, as tests/test_bench_contract.py holds the JAX bench to
it: ``bench.main(argv, device="cpu")`` in a subprocess prints a record line
after every section, writes a valid sidecar at ``--detail_file``, still
prints a parseable line when a section fails, and re-prints the latest line
on SIGTERM; the default budget keeps its margin. Without a card the command
line exits non-zero and prints no record.

Parity with the root bench.py (read with ``ast``, never run): the compact
keys and metric name, the detail keys (minus the JAX keys with no
counterpart, plus the port's own), the env switches, the proxy's shapes and
confs, the search configuration, the candidate counts and the paired-median
arithmetic. The FLOP count of one found-net train step at the CPU shrink's
shapes against XLA's cost analysis of the JAX step on the same numpy
weights: ``FlopCounterMode`` counts convolutions and matmuls over every
output position, padding included, and nothing else, while XLA counts only
the window positions that fall inside the input, plus elementwise and Adam
FLOPs. At 2 frames of 32 px the padded positions dominate: the torch count
is 1.263x XLA's; it must lie within 1.0-1.35x of it.
"""

import ast
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from mfas_tpu_torch import bench as tbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
PORT_BENCH = os.path.join(REPO, "mfas_tpu_torch", "bench.py")
RUN = ("import sys; from mfas_tpu_torch import bench; "
       "bench.main(sys.argv[1:], device='cpu')")
# the JAX bench's detail keys with no counterpart in the port (TPU compile
# cache, chunked H2D), and the port's own
NO_COUNTERPART = {"compile_cache_dir", "e2e_train_clips_per_s_chunked"}
PORT_ONLY = {"power_limit_w", "kernel_build_s", "kernel_launches",
             "allow_tf32_matmul", "allow_tf32_cudnn"}
FLOP_RATIO = (1.0, 1.35)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU shapes' ops are far too small to split,
    and under a parallel test runner every split op waits on threads the
    other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env(**extra):
    env = dict(os.environ)
    env.update({"MFAS_BENCH_FAST": "1", "MFAS_BENCH_BF16": "0",
                "OMP_NUM_THREADS": "1"})
    env.update({k: str(v) for k, v in extra.items()})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cmd(detail_file):
    return [sys.executable, "-c", RUN, "--detail_file", str(detail_file)]


def _record_lines(stdout):
    recs = []
    for line in stdout.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("metric") == tbench.METRIC:
            recs.append(rec)
    return recs


# --------------------------------------------------------------------------
# the output contract (tests/test_bench_contract.py's five cases)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bench_fast")
    proc = subprocess.run(_cmd(tmp / "detail.json"),
                          env=_env(MFAS_BENCH_BUDGET_S="600"), cwd=str(tmp),
                          capture_output=True, text=True, timeout=600)
    return proc, tmp


def test_fast_run_exits_zero_and_prints_records(fast_run):
    proc, _ = fast_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = _record_lines(proc.stdout)
    assert len(recs) >= 2, proc.stdout[-3000:]
    final = recs[-1]
    assert "partial_after_section" not in final
    assert "errors" not in final, final
    assert final["unit"] == "x"
    assert isinstance(final["value"], (int, float)) and final["value"] > 0
    assert final["vs_baseline"] == final["value"]
    assert final["measured_at"]
    assert final["detail_file"] == "detail.json"
    assert set(final["detail"]) <= set(tbench._COMPACT_KEYS)
    assert recs[0]["partial_after_section"] == "bench_proxy"
    assert recs[0]["unit"] == "x"


def test_fast_run_sidecar_is_valid_json(fast_run):
    proc, tmp = fast_run
    assert proc.returncode == 0
    # the run wrote only its --detail_file, never the default sidecars
    assert sorted(os.listdir(tmp)) == ["detail.json"]
    with open(tmp / "detail.json") as f:
        record = json.load(f)
    detail = record["detail"]
    assert detail["device_kind"] == "cpu"
    assert record["measured_at"]
    assert (detail["batch"], detail["img"], detail["K"]) == (2, 32, 15)
    assert detail["allow_tf32_matmul"] is False
    assert detail["allow_tf32_cudnn"] is False
    assert detail["kernel_build_s"] is None
    assert detail["kernel_launches"]["bench_proxy"] == {
        "u8_normalize": 0, "u8_gather_normalize": 0}
    # a --detail_file run carries nothing forward
    assert not any(k.endswith("_carried_from") for k in detail)
    assert detail["found_train_step_tflops"] > 0


def test_injected_section_failure_still_prints_parseable_line(tmp_path):
    proc = subprocess.run(
        _cmd(tmp_path / "detail.json"),
        env=_env(MFAS_BENCH_INJECT_ERROR="bench_proxy"), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = _record_lines(proc.stdout)
    assert recs, proc.stdout[-3000:]
    final = recs[-1]
    assert final.get("errors", 0) >= 1
    assert "bench_proxy_error" in final.get("error_keys", [])


def test_sigterm_reprints_latest_record(tmp_path):
    """The first line comes before any heavy work (the proxy fails at
    once), then a stuck section takes SIGTERM."""
    errfile = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(
        _cmd(tmp_path / "detail.json"),
        env=_env(MFAS_BENCH_INJECT_ERROR="bench_proxy",
                 MFAS_BENCH_HANG_S="300"),
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=errfile, text=True)
    try:
        first = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.strip().startswith("{"):
                first = line
                break
            if line == "" and proc.poll() is not None:
                break
        assert first is not None, \
            "no record line before deadline: " + \
            (tmp_path / "stderr.txt").read_text()[-2000:]
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        errfile.close()
    assert proc.returncode == tbench.SIGNAL_EXIT
    recs = _record_lines(first + rest)
    assert len(recs) >= 2, first + rest
    last = recs[-1]
    assert last["metric"] == tbench.METRIC
    assert "value" in last and "vs_baseline" in last
    assert (first + rest).rstrip().splitlines()[-1] == json.dumps(last)


def test_default_budget_has_margin():
    src = open(PORT_BENCH).read()
    m = re.search(r'MFAS_BENCH_BUDGET_S",\s*"(\d+)"', src)
    assert m, "budget default not found"
    assert int(m.group(1)) <= 3060, "soft budget must be <=85% of 3600"
    jax_src = open(JAX_BENCH).read()
    assert m.group(1) == re.search(r'MFAS_BENCH_BUDGET_S",\s*"(\d+)"',
                                   jax_src).group(1)


def test_no_card_exits_nonzero_without_a_record(tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("MFAS_BENCH_FAST")
    proc = subprocess.run([sys.executable, "-m", "mfas_tpu_torch.bench",
                           "--detail_file", str(tmp_path / "d.json")],
                          env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert not _record_lines(proc.stdout), proc.stdout
    assert "needs a CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "d.json")


# --------------------------------------------------------------------------
# carry-forward: only the default sidecar, only from a card of this name
# --------------------------------------------------------------------------
def _run_for(path, prev_kind, is_default, kind="NVIDIA H100 80GB HBM3"):
    import torch

    with open(path, "w") as f:
        json.dump({"measured_at": "then", "detail": {
            "device_kind": prev_kind, "search_trend_speedup": 3.0,
            "search_trend_config": {"x": 1}}}, f)
    return tbench.BenchRun(
        device=torch.device("cpu"), detail_file=str(path), budget_s=10,
        full=False, t0=time.perf_counter(),
        carry_source=tbench._load_carry_source(str(path), is_default, kind))


@pytest.mark.parametrize("prev_kind,is_default,carried", [
    ("NVIDIA H100 80GB HBM3", True, True),
    ("NVIDIA H100 PCIe", True, False),
    ("NVIDIA H100 80GB HBM3", False, False),
])
def test_carry_forward_source(tmp_path, prev_kind, is_default, carried):
    run = _run_for(tmp_path / "prev.json", prev_kind, is_default)
    detail = {}
    keys = ["search_trend_config", "search_trend_speedup",
            "search_trend_pop_s"]
    tbench._carry_forward(detail, run, keys, "why")
    if carried:
        assert detail["search_trend_speedup"] == 3.0
        assert detail["search_trend_config"] == {"x": 1}
        stamp = detail["search_trend_config_carried_from"]
        assert stamp["measured_at"] == "then"
        assert stamp["skip_reason"] == "why"
        assert "search_trend_config_skipped" not in detail
    else:
        assert detail == {"search_trend_config_skipped": "why"}


# --------------------------------------------------------------------------
# parity with the root bench.py, read with ast
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py as a module (it imports numpy only at the top)."""
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(JAX_BENCH) as f:
        mod.tree = ast.parse(f.read())
    return mod


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigns(fn, *names):
    """The statements of ``fn`` that assign any of ``names`` (alone or in a
    tuple), in order."""
    def targets(n):
        for t in n.targets:
            yield from (t.elts if isinstance(t, ast.Tuple) else [t])

    return [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id in names
                    for t in targets(n))]


def _exec(stmts, **ns):
    ns.setdefault("np", np)
    mod = ast.Module(body=stmts, type_ignores=[])
    exec(compile(ast.fix_missing_locations(mod), "<jax bench>", "exec"), ns)
    return ns


def _const(fn, name):
    return _exec(_assigns(fn, name)[:1])[name]


def _detail_keys(tree):
    """The constant keys a bench writes into ``detail``."""
    keys = set()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
                and isinstance(n.value, ast.Name) and n.value.id == "detail"
                and isinstance(n.slice, ast.Constant)):
            keys.add(n.slice.value)
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and isinstance(n.func.value, ast.Name)
              and n.func.value.id == "detail" and n.args):
            arg = n.args[0]
            if n.func.attr == "update" and isinstance(arg, ast.Dict):
                keys |= {k.value for k in arg.keys
                         if isinstance(k, ast.Constant)}
            elif n.func.attr == "setdefault" and isinstance(arg,
                                                            ast.Constant):
                keys.add(arg.value)
        elif (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "detail"
                      for t in n.targets)):
            keys |= {k.value for k in n.value.keys
                     if isinstance(k, ast.Constant)}
    return keys


def test_compact_keys_metric_and_constants(jax_bench):
    assert tbench._COMPACT_KEYS == jax_bench._COMPACT_KEYS
    src = open(JAX_BENCH).read()
    assert f'"metric": "{tbench.METRIC}"' in src
    assert (tbench.INNER, tbench.INNER_HEAD) == (jax_bench.INNER,
                                                 jax_bench.INNER_HEAD)
    assert tbench._ntu_args() == jax_bench._ntu_args()
    assert re.search(r"os\._exit\((\d+)\)", src).group(1) == \
        str(tbench.SIGNAL_EXIT)


def test_detail_keys_match_jax(jax_bench):
    """Section failures aside: both benches name them <section>_error, the
    JAX bench partly with constant keys."""
    def keys(tree):
        return {k for k in _detail_keys(tree) if not k.endswith("_error")}

    with open(PORT_BENCH) as f:
        port = keys(ast.parse(f.read()))
    jax_keys = keys(jax_bench.tree)
    assert NO_COUNTERPART <= jax_keys
    assert port == (jax_keys - NO_COUNTERPART) | PORT_ONLY, (
        sorted(port ^ ((jax_keys - NO_COUNTERPART) | PORT_ONLY)))


def test_env_switches_match_jax():
    def switches(path):
        with open(path) as f:
            return set(re.findall(r"MFAS_BENCH_[A-Z0-9_]+", f.read()))

    assert switches(PORT_BENCH) == switches(JAX_BENCH) == {
        f"MFAS_BENCH_{s}" for s in ("BUDGET_S", "FULL", "FAST", "BF16",
                                    "SEQ_MEASURED", "TREND", "FULLSCALE",
                                    "INJECT_ERROR", "HANG_S")}


def test_proxy_shapes_and_confs_match_jax(jax_bench):
    fn = _function(jax_bench.tree, "bench_proxy")
    B, IMG, K = (_const(fn, n) for n in ("B", "IMG", "K"))
    assert (tbench.PROXY_BATCH, tbench.PROXY_IMG, tbench.PROXY_K) == \
        (B, IMG, K) == (16, 256, 15)
    ns = _exec(_assigns(fn, "rows", "confs_K", "conf1"), K=K)
    confs_K, conf1 = tbench.proxy_confs(K)
    assert [c.tolist() for c in confs_K] == [c.tolist()
                                             for c in ns["confs_K"]]
    assert [c.tolist() for c in conf1] == [c.tolist() for c in ns["conf1"]]
    # the found net: Searchable_Skeleton_Image_Net(fargs, np.array(conf))
    build = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", "") ==
                 "Searchable_Skeleton_Image_Net")
    conf = eval(compile(ast.Expression(build.args[1]), "<conf>", "eval"),
                {"np": np})
    assert conf.tolist() == tbench.FOUND_CONF
    fargs = _assigns(fn, "fargs")[0].value
    assert {k.arg: ast.literal_eval(k.value) for k in fargs.keywords} == \
        tbench.FOUND_ARGS
    # the CPU shrink: B, IMG, INNER, INNER_HEAD = 2, 32, 1, 2 and
    # _ntu_args(vid_len=(2, 32))
    shrink = next(n for n in _assigns(fn, "INNER")
                  if isinstance(n.targets[0], ast.Tuple))
    names = [t.id for t in shrink.targets[0].elts]
    values = dict(zip(names, ast.literal_eval(shrink.value)))
    cpu_args = next(n for n in _assigns(fn, "args")
                    if n.value.keywords).value.keywords
    assert tbench.CPU_SHRINK == {
        "batch": values["B"], "img": values["IMG"],
        "inner": values["INNER"], "inner_head": values["INNER_HEAD"],
        "vid_len": ast.literal_eval(cpu_args[0].value)}


def test_search_args_match_jax(jax_bench, tmp_path):
    want = vars(jax_bench._search_args(str(tmp_path / "p"), str(tmp_path),
                                       16, epochs=2))
    got = vars(tbench._search_args(str(tmp_path / "p"), str(tmp_path), 16,
                                   epochs=2))
    shared = set(want) & set(got)
    assert {"packed_datadir", "batchsize", "epochs", "num_samples",
            "max_progression_levels", "search_iterations", "epochs_surrogate",
            "device_input_normalize", "num_workers", "num_outputs",
            "random_backbones", "seed", "verbose"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_candidate_counts_match_jax(jax_bench, tmp_path):
    fn = _function(jax_bench.tree, "bench_search_wallclock")
    args = tbench._search_args(str(tmp_path), str(tmp_path), 16)
    ns = _exec(_assigns(fn, "n_trained"), args=args)
    assert tbench.n_candidates(1, args.max_progression_levels,
                               args.num_samples) == ns["n_trained"] == 36
    for name, cfg, want in (
            ("n_big", dict(search_iterations=2, max_progression_levels=3,
                           num_samples=8), 72),
            ("n_full", dict(search_iterations=3, max_progression_levels=4,
                            num_samples=15, epochs=3), 197)):
        ns = _exec(_assigns(fn, name), big=cfg, full=cfg)
        assert tbench.n_candidates(cfg["search_iterations"],
                                   cfg["max_progression_levels"],
                                   cfg["num_samples"]) == ns[name] == want


@pytest.mark.parametrize("pairs", [
    [(10.0, 2.0), (12.0, 2.5), (9.0, 1.9), (30.0, 2.1), (11.0, 2.2)],
    [(10.0, 2.0), (12.0, 2.5)],
    [(5.0, 1.0)],
])
def test_paired_median_matches_jax(jax_bench, pairs):
    fn = _function(jax_bench.tree, "bench_search_wallclock")
    ns = _exec(_assigns(fn, "pair_ratios", "n_r", "speedup_paired"),
               pairs=pairs, n_trained=36)
    speedup, ratios = tbench.paired_speedup(pairs, 36)
    assert ratios == ns["pair_ratios"]
    assert speedup == ns["speedup_paired"]


# --------------------------------------------------------------------------
# FLOPs of one found-net train step: FlopCounterMode against XLA
# --------------------------------------------------------------------------
def test_found_step_flops_against_xla():
    import jax
    import jax.numpy as jnp
    import torch

    from mfas_tpu.core.module import (Rng, flatten_tree, partition,
                                      unflatten_tree)
    from mfas_tpu.core.optim import adam_init
    from mfas_tpu.engine.classifier import ClassifierEngine as JEngine
    from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net as JNet
    from mfas_tpu_torch.engine.classifier import (ClassifierEngine,
                                                  set_trainable)
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net

    shrink = tbench.CPU_SHRINK
    B, IMG = shrink["batch"], shrink["img"]
    rs = np.random.RandomState(0)
    rgb = rs.randn(B, shrink["vid_len"][0], IMG, IMG, 3).astype(np.float32)
    ske = rs.randn(B, 3, shrink["vid_len"][1], 25, 2).astype(np.float32)
    label = rs.randint(0, 60, B).astype(np.int32)
    fargs = tbench._ntu_args(**tbench.FOUND_ARGS)

    net = Searchable_Skeleton_Image_Net(
        fargs, np.array(tbench.FOUND_CONF), device="cpu",
        generator=torch.Generator().manual_seed(0))
    weights = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    set_trainable(net, None)
    engine = ClassifierEngine(net, "cpu", multitask=True,
                              input_keys=("rgb", "ske"))
    batch = {"rgb": torch.as_tensor(rgb), "ske": torch.as_tensor(ske),
             "label": torch.as_tensor(label), "_mask": torch.ones(B)}
    net.train()
    torch_flops = tbench.found_train_step_flops(engine, batch,
                                                engine.make_optimizer())

    # the JAX step on the same numpy weights (the tree's structure from
    # eval_shape: JAX's eager init of ResNet-50 takes ~20 s on the CPU)
    jnet = JNet(fargs, np.array(tbench.FOUND_CONF))
    keys = set(flatten_tree(jax.eval_shape(lambda: jnet.init(0))))
    assert keys == set(weights)
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in weights.items()})
    trainable, frozen = partition(tree, jnet.param_predicate())
    jengine = JEngine(jnet, multitask=True, input_keys=("rgb", "ske"))
    jbatch = {"rgb": jnp.asarray(rgb), "ske": jnp.asarray(ske),
              "label": jnp.asarray(label), "_mask": jnp.ones((B,))}
    lowered = jax.jit(jengine._train_step_impl).lower(
        trainable, frozen, adam_init(trainable), jbatch, jnp.float32(1e-3),
        Rng(0).next())
    cost = lowered.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla_flops = float(cost["flops"])
    ratio = torch_flops / xla_flops
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], (torch_flops, xla_flops)
