"""The port's 3DGAN against the reference on the same (bridged) weights and
the same numpy z, energies and images: generator images, the three
discriminator heads, both losses and their metrics, every gradient, and
three (D, G) RMSProp step pairs; parameter counts, configs, the bridge's
conv-leaf transposes, SAME padding, and the channels-last flatten the
heads depend on.

Tolerances (f32 on both sides; XLA's CPU convolutions and oneDNN's sum in
another order):
- images: max |port - ref| <= 1e-5 x max |ref| (observed ~3.5e-7);
- heads: 1e-4 absolute, in logit units and GeV (observed 1.1e-5): each is
  a 4,096-term dot product whose terms sum to |w| @ |h| ~ 10, times
  e_scale 100 for the energy heads, so f32 rounding alone reaches ~1e-5;
- losses and metrics: rtol 1e-5 (observed <= 3e-6, on ``fake_total_e``,
  a sum over 25^3 cells of each image);
- gradients, leaf by leaf: max |port - ref| <= 5e-5 x max |ref| (observed
  <= 7e-6);
- three step pairs: losses rtol 1e-5 and every parameter within 1e-5
  absolute (observed 1.8e-6).  RMSProp's first update is close to lr x
  sign(g) / sqrt(0.1), so only a gradient entry within rounding of zero
  could flip an update's sign; none does here.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch import optim as popt
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.distributed.stepfn import value_and_grad
from repro_torch.models import gan3d as PG

torch.set_num_threads(2)

FWD_REL = 1e-5
HEAD_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 5e-5
STEP_ATOL = 1e-5
SMOKE = dict(g_base=8, d_base=4)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, rel * scale)


def _flat(tree):
    from repro.checkpoint.ckpt import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


def _setup(cfg_kw, batch):
    """Reference params (jax.random at seed 0 / fold_in 1), the port's
    bridged copies, one calorimeter batch and a numpy z."""
    import jax

    from repro.data import CalorimeterSpec, generate_batch
    from repro.models import gan3d as JG
    jc, pc = JG.GAN3DConfig(**cfg_kw), PG.GAN3DConfig(**cfg_kw)
    key = jax.random.PRNGKey(0)
    # jitted: one program per tree, twice as fast as op by op on the CPU
    jg = jax.jit(JG.init_generator, static_argnums=1)(key, jc)
    jd = jax.jit(JG.init_discriminator, static_argnums=1)(
        jax.random.fold_in(key, 1), jc)
    data = generate_batch(CalorimeterSpec(), batch)
    z = np.random.default_rng(0).standard_normal(
        (batch, jc.latent_dim)).astype(np.float32)
    return dict(jc=jc, pc=pc, jg=jg, jd=jd,
                pg=bridge.gan_from_flat(_flat(jg)),
                pd=bridge.gan_from_flat(_flat(jd)), data=data, z=z)


@pytest.fixture(scope="module")
def smoke():
    return _setup(SMOKE, 4)


@pytest.fixture(scope="module")
def full():
    return _setup({}, 2)


def _jax_count(tree):
    from repro.models import gan3d as JG
    return JG.param_count(tree)


def _jb(data):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in data.items()}


def _pb(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


# ---------------------------------------------------------------------------
# configs, counts, the bridge
# ---------------------------------------------------------------------------

def test_configs_match_the_reference_number_for_number():
    import dataclasses

    from repro.configs import gan3d as jcfg
    from repro_torch.configs import gan3d as pcfg
    for j, p in ((jcfg.CONFIG, pcfg.CONFIG),
                 (jcfg.SMOKE_CONFIG, pcfg.SMOKE_CONFIG)):
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert get_config("gan3d") == pcfg.CONFIG
    assert get_smoke_config("gan3d") == pcfg.SMOKE_CONFIG
    assert "gan3d" not in ARCHS


def test_parameter_counts_match_the_reference(smoke, full):
    gen = torch.Generator().manual_seed(0)
    for s in (full, smoke):
        counts = [(_jax_count(s["jg"]), PG.param_count(
                      PG.init_generator(s["pc"], gen))),
                  (_jax_count(s["jd"]), PG.param_count(
                      PG.init_discriminator(s["pc"], gen)))]
        assert all(j == p for j, p in counts), counts
    assert [PG.param_count(full[k]) for k in ("pg", "pd")] == [719_053,
                                                               334_403]


def test_bridge_transposes_conv_leaves_and_round_trips(smoke):
    for tree, ptree in ((smoke["jg"], smoke["pg"]), (smoke["jd"], smoke["pd"])):
        flat = _flat(tree)
        back = bridge.gan_to_flat(ptree)
        assert back.keys() == flat.keys()
        for k, v in flat.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # DHWIO (5, 5, 5, 1, 4) -> OIDHW (4, 1, 5, 5, 5); heads pass as is
    assert tuple(smoke["pd"]["c1"]["w"].shape) == (4, 1, 5, 5, 5)
    assert tuple(smoke["pd"]["head_adv"]["w"].shape) == (4 * 4 * 4 * 16, 1)
    assert tuple(smoke["pg"]["fc"]["w"].shape) == (201, 7 * 7 * 7 * 10)


# ---------------------------------------------------------------------------
# SAME padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,stride,want", [
    (25, 5, 2, (2, 2)), (13, 5, 2, (2, 2)), (7, 5, 2, (2, 2)),
    (7, 3, 1, (1, 1)), (24, 5, 2, (1, 2)), (8, 3, 2, (0, 1))])
def test_same_padding_follows_xla(n, k, stride, want):
    assert PG.same_padding(n, k, stride) == want


def test_asymmetric_same_conv_matches_lax():
    """Shapes where XLA pads (1, 2) and (0, 1): the explicit ``F.pad``
    branch against ``lax.conv_general_dilated``."""
    import jax.numpy as jnp

    from repro.models import gan3d as JG
    rng = np.random.default_rng(1)
    for shape, k in (((2, 24, 8, 10, 3), 5), ((1, 8, 9, 8, 2), 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal((k, k, k, shape[-1], 4)).astype(np.float32)
        b = rng.standard_normal(4).astype(np.float32)
        ref = np.asarray(JG.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(x), stride=2))
        got = PG.conv3d({"w": torch.from_numpy(w.transpose(4, 3, 0, 1, 2)
                                               .copy()),
                         "b": torch.from_numpy(b)},
                        torch.from_numpy(x).permute(0, 4, 1, 2, 3), stride=2)
        _close(got.permute(0, 2, 3, 4, 1).numpy(), ref, FWD_REL)


# ---------------------------------------------------------------------------
# forward, losses, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["smoke", "full"])
def test_generator_and_heads_match_the_reference(width, smoke, full):
    import jax.numpy as jnp

    from repro.models import gan3d as JG
    s = smoke if width == "smoke" else full
    e = s["data"]["energies"]
    ref = np.array(JG.generator(s["jg"], s["jc"], jnp.asarray(s["z"]),
                                  jnp.asarray(e)))
    with torch.no_grad():
        got = PG.generator(s["pg"], s["pc"], torch.from_numpy(s["z"]),
                           torch.from_numpy(e))
    assert tuple(got.shape) == (len(e), 25, 25, 25, 1)
    _close(got.numpy(), ref, FWD_REL)
    for img in (s["data"]["images"], ref):
        jo = JG.discriminator(s["jd"], s["jc"], jnp.asarray(img))
        with torch.no_grad():
            po = PG.discriminator(s["pd"], s["pc"], torch.from_numpy(img))
        assert jo.keys() == po.keys()
        for k in jo:
            np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                       rtol=0, atol=HEAD_ATOL, err_msg=k)


@pytest.mark.parametrize("loss", ["d_loss", "g_loss"])
def test_losses_metrics_and_gradients_match_the_reference(loss, smoke):
    import jax
    import jax.numpy as jnp

    from repro.models import gan3d as JG
    s = smoke
    own, other = ("jd", "jg") if loss == "d_loss" else ("jg", "jd")
    jgrad, jm = jax.grad(getattr(JG, loss), has_aux=True)(
        s[own], s[other], s["jc"], _jb(s["data"]), jnp.asarray(s["z"]))
    pown, pother = "p" + own[1], "p" + other[1]
    _, pm, pgrad = value_and_grad(
        lambda p, b: getattr(PG, loss)(p, s[pother], s["pc"], b,
                                       torch.from_numpy(s["z"])),
        s[pown], _pb(s["data"]))
    assert jm.keys() == pm.keys()
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    jf, pf = _flat(jgrad), bridge.gan_to_flat(pgrad)
    assert jf.keys() == pf.keys()
    assert any(np.abs(v).max() > 0 for v in jf.values())
    for k in jf:
        _close(pf[k], jf[k], GRAD_REL)


def test_d_loss_gradient_does_not_reach_the_generator(smoke):
    """d_loss sees G's image detached: no gradient path to G's leaves
    (the reference's ``stop_gradient``), while every D leaf gets one."""
    s = smoke

    def aliases(tree):
        leaves = []

        def alias(t):
            leaves.append(t.detach().requires_grad_(True))
            return leaves[-1]
        return popt.tree_map(alias, tree), leaves

    (d, d_leaves), (g, g_leaves) = aliases(s["pd"]), aliases(s["pg"])
    loss, _ = PG.d_loss(d, g, s["pc"], _pb(s["data"]),
                        torch.from_numpy(s["z"]))
    grads = torch.autograd.grad(loss, d_leaves + g_leaves, allow_unused=True)
    assert all(t is not None for t in grads[:len(d_leaves)])
    assert all(t is None for t in grads[len(d_leaves):])


def test_heads_need_the_channels_last_flatten(smoke, monkeypatch):
    """Flattening the last volume in NCDHW order, without the permute,
    feeds the heads' rows the wrong features: the check above fails."""
    import jax.numpy as jnp

    from repro.models import gan3d as JG
    s = smoke
    img = s["data"]["images"]
    jo = JG.discriminator(s["jd"], s["jc"], jnp.asarray(img))
    monkeypatch.setattr(PG, "_flatten_channels_last",
                        lambda h: h.reshape(h.shape[0], -1))
    with torch.no_grad():
        po = PG.discriminator(s["pd"], s["pc"], torch.from_numpy(img))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(po["adv_logit"].numpy(),
                                   np.asarray(jo["adv_logit"]), rtol=0,
                                   atol=HEAD_ATOL)


def test_leaky_relu_takes_jax_slope_at_zero(smoke, monkeypatch):
    """``jax.nn.leaky_relu`` has slope 1 at x == 0, ``F.leaky_relu`` 0.2;
    the sparse showers and zero biases put exact zeros into D's first
    layers, so with ``F.leaky_relu`` the gradient check above fails."""
    import jax
    import jax.numpy as jnp

    from repro.models import gan3d as JG
    s = smoke
    jgrad, _ = jax.grad(JG.d_loss, has_aux=True)(
        s["jd"], s["jg"], s["jc"], _jb(s["data"]), jnp.asarray(s["z"]))
    monkeypatch.setattr(PG, "_leaky_relu",
                        lambda x: torch.nn.functional.leaky_relu(x, 0.2))
    _, _, pgrad = value_and_grad(
        lambda p, b: PG.d_loss(p, s["pg"], s["pc"], b,
                               torch.from_numpy(s["z"])),
        s["pd"], _pb(s["data"]))
    with pytest.raises(AssertionError):
        _close(bridge.gan_to_flat(pgrad)["c1/b"], _flat(jgrad)["c1/b"],
               GRAD_REL)


# ---------------------------------------------------------------------------
# three (D, G) step pairs
# ---------------------------------------------------------------------------

def test_three_step_pairs_match_the_reference_jitted_steps(smoke):
    """RMSProp with clip_norm 1.0, D at half the G rate (the example's
    optimizers), one jitted reference step pair against the port's."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
    from repro.data import CalorimeterSpec, generate_batch
    from repro.models import gan3d as JG
    s = smoke
    jc, pc = s["jc"], s["pc"]
    jdo, jgo = jopt.rmsprop(1.5e-4, clip_norm=1.0), jopt.rmsprop(
        3e-4, clip_norm=1.0)
    pdo, pgo = popt.rmsprop(1.5e-4, clip_norm=1.0), popt.rmsprop(
        3e-4, clip_norm=1.0)

    @jax.jit
    def jstep(dp, ds, gp, gs, b, z1, z2):
        gd, dm = jax.grad(JG.d_loss, has_aux=True)(dp, gp, jc, b, z1)
        u, ds = jdo.update(gd, ds, dp)
        dp = jopt.apply_updates(dp, u)
        gg, gm = jax.grad(JG.g_loss, has_aux=True)(gp, dp, jc, b, z2)
        u, gs = jgo.update(gg, gs, gp)
        return dp, ds, jopt.apply_updates(gp, u), gs, dm, gm

    jd, jg, pd, pg = s["jd"], s["jg"], s["pd"], s["pg"]
    jds, jgs, pds, pgs = jdo.init(jd), jgo.init(jg), pdo.init(pd), pgo.init(pg)
    rng = np.random.default_rng(3)
    for i in range(3):
        data = generate_batch(CalorimeterSpec(), 4, step=i)
        z1, z2 = rng.standard_normal((2, 4, jc.latent_dim)).astype(np.float32)
        jd, jds, jg, jgs, jdm, jgm = jstep(jd, jds, jg, jgs, _jb(data),
                                           jnp.asarray(z1), jnp.asarray(z2))
        _, pdm, gr = value_and_grad(
            lambda p, b: PG.d_loss(p, pg, pc, b, torch.from_numpy(z1)), pd,
            _pb(data))
        u, pds = pdo.update(gr, pds, pd)
        pd = popt.apply_updates(pd, u)
        _, pgm, gr = value_and_grad(
            lambda p, b: PG.g_loss(p, pd, pc, b, torch.from_numpy(z2)), pg,
            _pb(data))
        u, pgs = pgo.update(gr, pgs, pg)
        pg = popt.apply_updates(pg, u)
        np.testing.assert_allclose(float(pdm["d_loss"]), float(jdm["d_loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pgm["g_loss"]), float(jgm["g_loss"]),
                                   rtol=LOSS_RTOL)
    for j, p in ((jd, pd), (jg, pg)):
        jf, pf = _flat(j), bridge.gan_to_flat(p)
        for k in jf:
            np.testing.assert_allclose(pf[k], jf[k], rtol=0, atol=STEP_ATOL,
                                       err_msg=k)
    # the parameters moved: the check above is not of the initial weights
    assert not np.allclose(_flat(jg)["c1/w"], _flat(s["jg"])["c1/w"],
                           rtol=0, atol=1e-5)
