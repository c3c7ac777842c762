"""Inspect a saved, crashed or running search without loading any model
(port of tools/search_report.py; same flags and output).

The search CLIs write the two files this reads:

  --search_state <pkl>   crash-resume snapshot (ModelSearcher._save_state)
  --jsonl_log <path>     per-event telemetry stream

    python -m mfas_tpu_torch.tools.search_report \\
        --search_state /ckpt/search.pkl [--top 5]
    python -m mfas_tpu_torch.tools.search_report --jsonl /ckpt/search.jsonl

Prints search progress (iteration / progression level / temperature),
the (conf, acc) store's per-level population, and the top-K architectures
in the format of the search CLIs' final listing. The search state is the
same pickle in both packages, so a state the JAX package wrote reads here
too. A host tool: it touches no device.
"""

import argparse
import json

import numpy as np


def report_state(path, top):
    from mfas_tpu_torch.search.searcher import ModelSearcher
    from mfas_tpu_torch.search.surrogate import SurrogateDataloader

    st = ModelSearcher.load_state(path)
    s_data = SurrogateDataloader.from_state(st["surrogate_data"])

    print(f"search state: {path}")
    print(f"  progress: search_iteration={st['si']} "
          f"progression_index={st['progression_index']} "
          f"temperature={st['temperature']:.4f}")
    print(f"  store: {len(s_data)} unique (conf, acc) entries")
    confs, accs = s_data.get_data()
    for group_conf, group_acc in zip(confs, accs):
        L, N = group_conf.shape[0], group_conf.shape[1]
        print(f"    {L}-row confs: {N} entries, "
              f"best {float(np.max(group_acc)):.4f}, "
              f"mean {float(np.mean(group_acc)):.4f}")
    if st.get("sampled_k_confs"):
        print(f"  last sampled K: {len(st['sampled_k_confs'])} confs")
    if st.get("shared_weights"):
        print(f"  weight-sharing store: {len(st['shared_weights'])} keys")

    k_best, k_accs, _ = s_data.get_k_best(min(top, len(s_data)))
    print("Now listing best architectures")
    for conf, acc in zip(k_best, k_accs):
        print(np.asarray(conf).tolist(), acc)


def report_jsonl(path):
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    print(f"telemetry: {path} ({len(events)} events)")
    by_kind = {}
    for e in events:
        by_kind.setdefault(e.get("kind", "?"), []).append(e)
    for kind, es in by_kind.items():
        print(f"  {kind}: {len(es)}")
    steps = [e for e in events if "temperature" in e]
    if steps:
        e = steps[-1]
        print(f"  last step: si={e.get('si')} "
              f"progression={e.get('progression')} "
              f"temperature={e.get('temperature'):.4f} "
              f"surrogate_size={e.get('surrogate_size')}")
    last = events[-1] if events else None
    if last is not None:
        print(f"  last event: {json.dumps(last, default=str)[:200]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--search_state", default="",
                    help="path of a --search_state pickle")
    ap.add_argument("--jsonl", default="", help="path of a telemetry jsonl")
    ap.add_argument("--top", type=int, default=5,
                    help="how many best architectures to list")
    args = ap.parse_args(argv)
    if not args.search_state and not args.jsonl:
        ap.error("pass --search_state and/or --jsonl")
    if args.search_state:
        report_state(args.search_state, args.top)
    if args.jsonl:
        report_jsonl(args.jsonl)


if __name__ == "__main__":
    main()
