"""B3, the ragged SSD scan (``csrc/ssd_chunk.cu``): the least time of its
calls in the profiled steps (float32 bytes or operations at the 3xTF32
peak, from each call's segments) over its kernel's device time (%)."""
from alora_bench.tracing import B3_KERNELS
from alora_bench.profile_read import roofline


def read(rec):
    return roofline(rec, "b3_bound_s", B3_KERNELS)
