"""Share of the memory roofline reached by `core_word_kernel` (grab_tpu_torch/csrc/corewords.cu)
over the traced requests, in % (metrics/_roofline.py)."""

from scanbench.metrics._roofline import roofline

KERNEL = "core_word_kernel"


def read(run):
    return roofline(run, KERNEL)
