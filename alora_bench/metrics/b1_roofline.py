"""B1, ragged paged attention (``csrc/paged_attention.cu``): the least
time of its calls in the profiled steps (bytes at 3.35 TB/s or
operations at 989 TFLOP/s, from each call's shapes) over the device
time of its tile and merge kernels there (%)."""
from alora_bench.tracing import B1_KERNELS
from alora_bench.profile_read import roofline


def read(rec):
    return roofline(rec, "b1_bound_s", B1_KERNELS)
