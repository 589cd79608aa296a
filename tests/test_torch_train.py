"""The port's training path (parallel/trainstep.py, data/dataset.py,
convert.save_checkpoint, tools/train.py) against radae_tpu on the CPU
(the routing of a forward that needs a gradient, and the re-pack after an
update: tests/test_torch_radae.py).

The loss's gradient is held against `jax.value_and_grad` of radae_tpu's
loss on the same weights, batch and channel draw (the `same_noise`
fixture), quant noise off: loss at rtol 1e-4 / atol 1e-5, each leaf within
1e-3 of that leaf's max |g|.  Adam with its LR schedule against radae_tpu's
optax chain on the same five gradients (rtol 1e-6); what is driven by the
noise (a dozen steps, remat) by its own consistency."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radae_tpu.config import RADAEConfig as JRADAEConfig
from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.convert import load_checkpoint as jload_checkpoint
from radae_tpu.convert import save_checkpoint as jsave_checkpoint
from radae_tpu.data.dataset import RADAEDataset as JRADAEDataset
from radae_tpu.models.core import distortion_loss as jdistortion_loss
from radae_tpu.models.radae import RADAE as JRADAE
from radae_tpu.parallel.trainstep import make_optimizer as jmake_optimizer
from radae_tpu_torch.channel.doppler import multipath_samples
from radae_tpu_torch.config import RADAEConfig, flagship_config
from radae_tpu_torch.convert import load_checkpoint, save_checkpoint
from radae_tpu_torch.data.dataset import RADAEDataset
from radae_tpu_torch.models.radae import RADAE, tree_leaves
from radae_tpu_torch.parallel.trainstep import (make_eval_step, make_loss_fn,
                                                make_optimizer,
                                                make_train_step,
                                                step_generator)
from radae_tpu_torch.tools import train
from tests.test_torch_channel import one_thread, same_noise  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fixtures", "model_fs_flagship.npz")
GRAD_TOL = 1e-3          # of each leaf's max |g|
FLAGS = ["--rate_Fs", "--pilots", "--pilot_eq", "--eq_ls", "--cp", "0.004",
         "--bottleneck", "3", "--range_EbNo", "--auxdata"]
META_KEYS = {"model_args", "dataset_args", "batch_size", "lr",
             "lr_decay_factor", "sequence_length", "adam_betas", "epoch",
             "loss"}


def _named(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _named(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _feats(B, T, F, seed=11):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((B, T, F))).astype(np.float32)
    if F == 21:
        f[..., 20] = np.sign(rng.standard_normal((B, T)))
    return f


def _rate_rs_cfg(cls=RADAEConfig, **kw):
    return cls(**dict(dict(feature_dim=20, latent_dim=80, EbNodB=10.0), **kw))


# -- the gradient against jax.value_and_grad ---------------------------------

GRAD_CASES = {
    # the flagship with multipath fading, aux BER on
    "flagship": (True, dict(EbNodB=5.0), True),
    "rate_rs_b1": (False, dict(feature_dim=20, latent_dim=80, EbNodB=8.0,
                               bottleneck=1), False),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_gradient_matches_jax(name, same_noise):
    flag, kw, fading = GRAD_CASES[name]
    kw = dict(kw, quant_noise=False)
    cfg = (flagship_config if flag else RADAEConfig)(**kw)
    jcfg = (jax_flagship_config if flag else JRADAEConfig)(**kw)
    model, jmodel = RADAE(cfg, "cpu"), JRADAE(jcfg)
    params = model.init(3)
    B, T = 2, 48
    feats = _feats(B, T, cfg.feature_dim)
    G = None
    if fading:
        n_fs = cfg.num_timesteps_at_rate_Fs(cfg.num_timesteps_at_rate_Rs(T))
        G = (0.7 * np.random.default_rng(12).standard_normal(
            (B, n_fs, 2, 2))).astype(np.float32)
    aux_ber = cfg.feature_dim == 21

    init_state, _ = make_train_step(model, aux_ber=aux_ber)
    state = init_state(params)
    leaves = dict(_named(state.params))
    loss, aux = make_loss_fn(model, aux_ber=aux_ber)(
        state.params, torch.as_tensor(feats), None, G, step_generator(
            "cpu", 0, 0))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))

    def jloss(p):
        fh = jmodel.forward(p, feats, None, G, key=jax.random.PRNGKey(0))[
            "features_hat"]
        return jdistortion_loss(jnp.asarray(feats), fh).mean(), fh

    (jl, jfh), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    if aux_ber:
        jaux = float((feats[..., 20] * np.asarray(jfh)[..., 20] < 0).mean())
        assert abs(float(aux) - jaux) <= 1.0 / (B * T)
    jg = dict(_named(jg))
    assert set(jg) == set(grads) and len(grads) == 78
    for k, g in grads.items():
        want = np.asarray(jg[k])
        scale = np.abs(want).max()
        assert scale > 0 and np.isfinite(g.numpy()).all(), k
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * scale, (k, err / scale)


# -- Adam and the LR schedule against optax ----------------------------------

def test_adam_and_schedule_match_optax():
    """Five gradients of mixed size (some below eps) through the port's
    Adam + LambdaLR and radae_tpu's optax chain: each update agrees at
    rtol 1e-6 (read off weights set to zero before each step, so nothing
    is lost to a subtraction), and the rate of update k is
    lr / (1 + decay k)."""
    lr, decay = 1e-2, 0.5
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-9, 1, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    mine = {k: torch.zeros(s, requires_grad=True) for k, s in shapes.items()}
    opt, sched = make_optimizer(lr, decay)(list(mine.values()))
    jopt = jmake_optimizer(lr, decay)
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jstate = jopt.init(jp)
    for k, g in enumerate(grads):
        assert sched.get_last_lr()[0] == pytest.approx(lr / (1 + decay * k),
                                                       rel=1e-12)
        for name, t in mine.items():
            with torch.no_grad():
                t.zero_()
            t.grad = torch.as_tensor(g[name])
        opt.step()
        sched.step()
        up, jstate = jopt.update({n: jnp.asarray(v) for n, v in g.items()},
                                 jstate, jp)
        for name, t in mine.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(up[name]), rtol=1e-6,
                                       atol=0, err_msg=f"update {k} {name}")


# -- the train step --------------------------------------------------------------

@pytest.fixture(scope="module")
def rate_rs():
    cfg = _rate_rs_cfg()
    model = RADAE(cfg, "cpu")
    return cfg, model, model.init(0)


def test_loss_falls_over_twelve_steps(rate_rs):
    cfg, model, params = rate_rs
    init_state, step = make_train_step(model, lr=3e-3)
    state = init_state(params)
    feats = _feats(8, 48, 20, 0)
    losses = []
    for _ in range(12):
        state, metrics = step(state, feats, None, None, 42)
        losses.append(float(metrics["loss"][0]))
    assert losses[-1] < losses[0], losses
    assert state.step == 12 and state.scheduler.last_epoch == 12


def test_remat_gives_the_same_gradients_with_noise():
    """Under remat the backward runs each core-net block again: the
    generator is set back to the block's start first, so the noise (quant
    noise) and the gradient are the same."""
    cfg = flagship_config(range_EbNo=True)
    model = RADAE(cfg, "cpu")
    state = make_train_step(model)[0](model.init(1))
    leaves = list(tree_leaves(state.params))
    feats = torch.as_tensor(_feats(2, 48, 21, 3))
    out = []
    for remat in (False, True):
        loss, _ = make_loss_fn(model, aux_ber=True, remat=remat)(
            state.params, feats, None, None, step_generator("cpu", 4, 0))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-9)


def _peak_bytes(fn):
    """The most bytes that fn's tensors held at once (torch.profiler's
    allocation and free events, on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    cur = peak = 0
    for e in sorted(p.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns()):
        if e.name() == "[memory]":
            cur += e.nbytes()
            peak = max(peak, cur)
    return peak


def test_remat_lowers_the_peak_memory():
    """The flagship's forward and backward with quant noise on: remat holds
    one core-net block's activations at a time, under 3/4 of the peak
    without it (about 0.4 of it at this size)."""
    cfg = flagship_config(range_EbNo=True)
    model = RADAE(cfg, "cpu")
    state = make_train_step(model)[0](model.init(1))
    feats = torch.as_tensor(_feats(2, 96, 21, 3))
    peaks = {}
    for remat in (False, True):
        loss_fn = make_loss_fn(model, aux_ber=True, remat=remat)

        def step():
            loss_fn(state.params, feats, None, None,
                    step_generator("cpu", 4, 0))[0].backward()
        peaks[remat] = _peak_bytes(step)
    assert 0 < peaks[True] < 0.75 * peaks[False], peaks


def test_eval_step_shapes(rate_rs):
    cfg, model, params = rate_rs
    loss, ebno, sigma = make_eval_step(model)(params, _feats(4, 48, 20),
                                              None, None, 0)
    assert loss.shape == (4,) and ebno.shape == (4,) and sigma.shape[0] == 4
    assert torch.isfinite(loss).all() and not loss.requires_grad


# -- checkpoints and the dataset -------------------------------------------------

def test_checkpoints_round_trip_both_ways(tmp_path):
    """Either package reads the other's checkpoint with the same leaves and
    meta; the train state's leaves are contiguous even where the npz holds
    transposed arrays (the fixture's; NCCL takes contiguous tensors
    only)."""
    model = RADAE(flagship_config(), "cpu")
    fixture = load_checkpoint(FIXTURE)[0]
    assert not all(v.flags.c_contiguous for _, v in _named(fixture))
    assert all(t.is_contiguous() for t in tree_leaves(
        make_train_step(model)[0](fixture).params))
    tree = model.init(2)
    state = make_train_step(model)[0](tree)
    meta = {"epoch": 3, "loss": 0.25, "model_args": {"auxdata": True}}
    mine, theirs = str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz")
    save_checkpoint(mine, state.params, meta)      # tensors that need grad
    jsave_checkpoint(theirs, tree, meta)
    for a, b in ((jload_checkpoint(mine), load_checkpoint(theirs)),
                 (load_checkpoint(mine), jload_checkpoint(mine))):
        assert a[1] == b[1] == meta
        a, b = dict(_named(a[0])), dict(_named(b[0]))
        want = dict(_named(tree))
        assert a.keys() == b.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(a[k], want[k], err_msg=k)
            np.testing.assert_array_equal(b[k], want[k], err_msg=k)


def _files(tmp_path, cfg, n_seq, T):
    feat = str(tmp_path / "f.f32")
    rows = np.random.default_rng(6).standard_normal((n_seq * T + 5, 36))
    rows.astype(np.float32).tofile(feat)
    gfile, hfile = str(tmp_path / "g.f32"), str(tmp_path / "h.f32")
    multipath_samples("mpp", cfg.Fs, cfg.Rs_dash, cfg.Nc, 6.0, H_fn=hfile,
                      G_fn=gfile, rng=np.random.default_rng(7))
    return feat, gfile, hfile


def test_dataset_matches_jax(tmp_path):
    cfg = flagship_config()
    T = 48
    feat, gfile, hfile = _files(tmp_path, cfg, 9, T)
    H_seq = cfg.num_timesteps_at_rate_Rs(T)
    G_seq = cfg.num_timesteps_at_rate_Fs(H_seq)
    args = (feat, T, H_seq, cfg.Nc, G_seq)
    kw = dict(h_file=hfile, g_file=gfile, rate_Fs=True, auxdata=True)
    mine, theirs = RADAEDataset(*args, **kw), JRADAEDataset(*args, **kw)
    assert len(mine) == len(theirs) == 9
    for i in (0, 4, 8):
        for a, b in zip(mine[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
    got = list(mine.batches(4, np.random.default_rng(3)))
    want = list(theirs.batches(4, np.random.default_rng(3)))
    assert len(got) == len(want) == 2
    for ga, wa in zip(got, want):
        for a, b in zip(ga, wa):
            np.testing.assert_array_equal(a, b)
    benign = RADAEDataset(*args, rate_Fs=True)
    assert benign[0][2].shape == (G_seq, 2) and (benign[0][2][:, 0] == 1).all()


# -- the train tool ----------------------------------------------------------------

def test_train_tool_epoch_resume_and_plot_EqNo(tmp_path, capsys):
    cfg = flagship_config()
    feat, gfile, _ = _files(tmp_path, cfg, 8, 48)
    out = str(tmp_path / "out")
    base = [feat, out] + FLAGS + ["--g_file", gfile, "--sequence-length",
                                  "48", "--batch-size", "4", "--device",
                                  "cpu"]
    train.main(base + ["--epochs", "1"])
    err = capsys.readouterr().err
    assert "epoch 1: loss" in err and "audio-sec/s" in err, err
    ckpt1 = f"{out}/checkpoints/checkpoint_epoch_1.npz"
    tree, meta = jload_checkpoint(ckpt1)
    assert set(meta) == META_KEYS and meta["epoch"] == 1
    assert meta["model_args"]["auxdata"] and meta["adam_betas"] == [0.8, 0.95]
    assert {k for k, _ in _named(tree)} == {
        k for k, _ in _named(RADAE(cfg, "cpu").init(0))}

    # resume at epoch 2, two steps a call: the epoch's 2 batches, 1 call
    train.main(base + ["--epochs", "2", "--initial-checkpoint", ckpt1,
                       "--scan-steps", "2"])
    err = capsys.readouterr().err
    assert "Loaded" in err and "epoch 2: loss" in err and "(2 batches" in err
    assert load_checkpoint(f"{out}/checkpoints/checkpoint_epoch_2.npz")[1][
        "epoch"] == 2

    train.main(base + ["--plot_EqNo", str(tmp_path / "eq"),
                       "--initial-checkpoint", ckpt1])
    bins = np.loadtxt(str(tmp_path / "eq_loss_EqNodB.txt"), ndmin=2)
    assert bins.shape[1] == 2 and len(bins) >= 1 and np.isfinite(bins).all()

    with pytest.raises(SystemExit, match="modem frames.*use 48"):
        train.main([feat, out] + FLAGS + ["--sequence-length", "50",
                                          "--device", "cpu"])


def test_scan_steps_equal_sequential_steps(tmp_path, capsys):
    """--scan-steps groups an epoch's batches and drops its last
    incomplete group (radae_tpu runs a group in one call): 3 groups of 1
    and 1 group of 3 give the same checkpoint to the bit, and groups of 2
    run 2 of the 3 batches.  Rate Rs, noise on."""
    feat = str(tmp_path / "f.f32")
    np.random.default_rng(8).standard_normal((12 * 48, 36)).astype(
        np.float32).tofile(feat)
    trees = {}
    for scan in (1, 3, 2):
        out = str(tmp_path / f"scan{scan}")
        train.main([feat, out, "--sequence-length", "48", "--batch-size", "4",
                    "--epochs", "1", "--scan-steps", str(scan), "--device",
                    "cpu"])
        err = capsys.readouterr().err
        assert f"({3 if scan != 2 else 2} batches" in err, err
        trees[scan] = dict(_named(load_checkpoint(
            f"{out}/checkpoints/checkpoint_epoch_1.npz")[0]))
    for k, v in trees[1].items():
        np.testing.assert_array_equal(trees[3][k], v, err_msg=k)
    assert any(not np.array_equal(trees[2][k], v) for k, v in trees[1].items())
