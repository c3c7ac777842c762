"""bn.kernel_pct: the traced device seconds of the fused BatchNorm kernels
(every kernel whose name holds ``mfas_bn_``, mfas_tpu_torch/csrc/
batchnorm.cu) as a share of the trace's busy seconds. None where no such
kernel ran in the trace (a program without them)."""

from perfbench.tracing import kernel_seconds


def read(outcome):
    trace = outcome.trace
    if trace is None or not trace["busy_s"]:
        return None
    launches, seconds = kernel_seconds(trace, "mfas_bn_")
    if not launches:
        return None
    return 100.0 * seconds / trace["busy_s"]
