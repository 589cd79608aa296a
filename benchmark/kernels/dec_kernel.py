"""`dec_kernel`: the core decoder over a receiving call's latents, from the
state in to the features and the state out."""

from benchmark.reference import roofline as r

MATCH = "dec_kernel"


def cost(work, cfg):
    if work["direction"] != "rx":
        return None
    return r.kernel_cost("dec", work["streams"], r.z_steps(work),
                         cfg["latent_dim"], cfg["feature_dim"])
