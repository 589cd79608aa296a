"""`dec_merged_kernel`: the core decoder with its GRU products merged; the
same work as `dec_kernel`."""

from benchmark.reference import roofline as r

MATCH = "dec_merged_kernel"


def cost(work, cfg):
    if work["direction"] != "rx":
        return None
    return r.kernel_cost("dec", work["streams"], r.z_steps(work),
                         cfg["latent_dim"], cfg["feature_dim"])
