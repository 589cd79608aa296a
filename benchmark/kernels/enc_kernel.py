"""`enc_kernel`: the core encoder over a sending call's features, from the
state in to the latents and the state out."""

from benchmark.reference import roofline as r

MATCH = "enc_kernel"


def cost(work, cfg):
    if work["direction"] != "tx":
        return None
    return r.kernel_cost("enc", work["streams"], r.z_steps(work),
                         cfg["latent_dim"], cfg["feature_dim"])
