"""`rx_frame_kernel`: a whole received frame a launch, the front end (CP
strip, DFT, pilot EQ, demap) and the decoder; its cost counts a call's
frames one by one."""

from benchmark.reference import roofline as r

MATCH = "rx_frame_kernel"


def cost(work, cfg):
    if work["direction"] != "rx":
        return None
    flops, nbytes = r.frame_cost(work["streams"], cfg)
    return flops * work["frames"], nbytes * work["frames"]
