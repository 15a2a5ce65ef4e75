"""Share of the memory roofline reached by `fused_kernel` (the -H batch's
single-pass ensemble, grab_tpu_torch/csrc/fused.cu) over the traced
requests, in % (metrics/_roofline.py). A bytes roofline: on the 110-pattern
batch the kernel is bound by its operations, far below this share's 100%."""

from scanbench.metrics._roofline import roofline

KERNEL = "fused_kernel"


def read(run):
    return roofline(run, KERNEL)
