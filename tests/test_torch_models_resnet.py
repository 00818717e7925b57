"""The port's ResNet population model (``hyperopt_tpu_torch.models.
resnet``) against the reference's flax model on the CPU.

Every parity case carries the reference's weights over through
``convert.resnet_params_from_numpy`` and feeds both packages the same
batch.  Tolerances, from the float32 rounding of two implementations of
the same layers (XLA's and PyTorch's convolutions, GroupNorm variances
-- flax's ``E[x^2] - E[x]^2`` against PyTorch's own -- and the
pooling sums):

* ACT_ATOL 1e-5 on the stem's and every block's activations and on the
  logits, all of magnitude a few units (measured about 6e-7);
* LOSS_RTOL 1e-5 on losses;
* PARAM_ATOL 1e-6 on parameters and momenta after one step (measured
  1.2e-7).

The tiny net of the reference tests: ``stage_sizes=(1, 1, 1)``, width
8, 8x8 images, so blocks 1 and 2 downsample through the stride-2 SAME
padding (flax pads (0, 1)) and the 1x1 projection shortcut.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.models import resnet as JR
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.models import resnet as TR
from hyperopt_tpu_torch.parallel.mesh import RankMesh, virtual_mesh

NET = dict(stage_sizes=(1, 1, 1), width=8)
ACT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
INIT_SIGMAS = 5.0  # as in test_torch_models_transformer.py
P_INIT = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def ref():
    """The reference net and a 64-member population of its init."""
    jm = JR.ResNet(**NET)
    pop = jax.jit(lambda k: JR.init_population(jm, P_INIT, k, image_size=8))(jax.random.key(0))
    return jm, _np(pop)


@pytest.fixture(scope="module")
def batch():
    return _np(JR.synthetic_cifar_batch(jax.random.key(1), 8, 8))


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("batch_size,image_size", [(8, 8), (16, 32)])
def test_synthetic_cifar_batch(seed, batch_size, image_size):
    """Labels bitwise; images ``means / 2 + normal / 2`` within the 2-ulp
    rule of the port's normals (``tests/test_torch_random.py``), carried
    through the sum (and its own rounding)."""
    j_img, j_lbl = _np(JR.synthetic_cifar_batch(jax.random.key(seed), batch_size, image_size))
    t_img, t_lbl = TR.synthetic_cifar_batch(R.key(seed), batch_size, image_size)
    assert t_lbl.dtype == torch.int64 and t_img.shape == j_img.shape
    np.testing.assert_array_equal(t_lbl.numpy(), j_lbl)
    noise = 0.5 * np.asarray(jax.random.normal(jax.random.split(jax.random.key(seed))[1],
                                               j_img.shape))
    bound = 2 * np.spacing(np.abs(noise).astype(np.float32)) + np.spacing(
        np.abs(j_img).astype(np.float32))
    assert (np.abs(t_img.numpy() - j_img) <= bound).all()
    np.testing.assert_array_equal(TR._class_means(10, "cpu").numpy(),
                                  np.asarray(jnp.linspace(-1.0, 1.0, 10)))


def test_convert_round_trip(ref):
    """Every flax leaf lands on the port's parameter of the same role and
    shape, with or without the population axis: HWIO -> OIHW, GroupNorm
    ``scale`` -> ``weight``, Dense transposed."""
    _, pop = ref
    tm = TR.ResNet(**NET)
    conv = convert.resnet_params_from_numpy(pop, device="cpu")
    assert {n: tuple(v.shape[1:]) for n, v in conv.items()} == {
        n: tuple(p.shape) for n, p in tm.named_parameters()}
    one = convert.resnet_params_from_numpy(jax.tree.map(lambda x: x[2], pop), device="cpu")
    assert all(torch.equal(conv[n][2], one[n]) for n in conv)
    np.testing.assert_array_equal(
        conv["blocks.1.shortcut.weight"].numpy().transpose(0, 3, 4, 2, 1),
        pop["BasicBlock_1"]["Conv_2"]["kernel"])
    np.testing.assert_array_equal(conv["stem.weight"].numpy().transpose(0, 3, 4, 2, 1),
                                  pop["Conv_0"]["kernel"])
    np.testing.assert_array_equal(conv["blocks.2.norm2.weight"].numpy(),
                                  pop["BasicBlock_2"]["GroupNorm_1"]["scale"])


@pytest.mark.parametrize("member", [0, 3])
def test_every_stage_and_the_logits(ref, batch, member):
    """The stem's activation and each block's output (NHWC in flax, NCHW
    here) and the logits: blocks 1 and 2 hold the stride-2 padding."""
    jm, pop = ref
    images, _ = batch
    params = jax.tree.map(lambda x: x[member], pop)
    logits, state = jm.apply({"params": params}, images, capture_intermediates=True,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    want = [np.maximum(np.asarray(inter["GroupNorm_0"]["__call__"][0]), 0.0)]
    want += [np.asarray(inter[f"BasicBlock_{i}"]["__call__"][0]) for i in range(3)]
    tm = TR.ResNet(**NET)
    tm.load_state_dict(convert.resnet_params_from_numpy(params, device="cpu"))
    with torch.no_grad():
        stage_out = tm.features(_t(images))
        got = tm(_t(images))
    assert [tuple(a.shape) for a in stage_out] == [w.transpose(0, 3, 1, 2).shape for w in want]
    for i, (a, w) in enumerate(zip(stage_out, want)):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1), w, rtol=0, atol=ACT_ATOL,
                                   err_msg=f"stage output {i}")
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0, atol=ACT_ATOL)


def test_cross_entropy_loss(ref, batch):
    import optax

    jm, pop = ref
    images, labels = batch
    params = jax.tree.map(lambda x: x[1], pop)
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        jm.apply({"params": params}, images), labels).mean())
    tm = TR.ResNet(**NET)
    logits = torch.func.functional_call(
        tm, convert.resnet_params_from_numpy(params, device="cpu"), (_t(images),))
    got = float(torch.nn.functional.cross_entropy(logits, _t(labels, torch.int64)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _steps(ref, batch, n_members, n_steps, lr, wd, momentum_scale=0.0, mesh=None):
    """Both packages' population steps from the same members (the port's
    placed on ``mesh``): the last losses and the final parameters and
    momenta, in the port's names."""
    jm, pop = ref
    images, labels = batch
    jp = jax.tree.map(lambda x: x[:n_members], pop)
    jmom = jax.tree.map(lambda x: momentum_scale * x, jp)
    tp = convert.resnet_params_from_numpy(jp, device="cpu")
    tmom = convert.resnet_params_from_numpy(jmom, device="cpu")
    jstep = JR.make_population_train_step(jm)
    tstep = TR.make_population_train_step(TR.ResNet(**NET), mesh=mesh, device="cpu")
    timg, tlbl = _t(images), _t(labels, torch.int64)
    for _ in range(n_steps):
        jp, jmom, jloss = _np(jstep(jp, jmom, lr, wd, images, labels))
        tp, tmom, tloss = tstep(tp, tmom, _t(lr), _t(wd), timg, tlbl)
        np.testing.assert_allclose(tloss.detach().numpy(), jloss, rtol=LOSS_RTOL)
    return jloss, (convert.resnet_params_from_numpy(jp, device="cpu"), tp), (
        convert.resnet_params_from_numpy(jmom, device="cpu"), tmom)


def test_member_step_params_momentum_and_loss(ref, batch):
    """One step of one member from a nonzero momentum: the same SGD rule
    (``m' = 0.9 m + g``, ``p' = p - lr (m' + wd p)``)."""
    lr, wd = np.array([0.1], np.float32), np.array([1e-3], np.float32)
    _, *pairs = _steps(ref, batch, 1, 1, lr, wd, momentum_scale=0.01)
    for want, got in pairs:
        for n in want:
            np.testing.assert_allclose(got[n].detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)


def test_population_step_of_four(ref, batch):
    """The vmapped step (grouped convolutions) against the reference's
    jitted one: four members with their own lr and wd, three steps."""
    lr = np.array([0.3, 0.1, 0.03, 0.01], np.float32)
    wd = np.array([1e-5, 1e-4, 1e-3, 1e-2], np.float32)
    jloss, (want, got), _ = _steps(ref, batch, 4, 3, lr, wd)
    for n in want:
        np.testing.assert_allclose(got[n].detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=10 * PARAM_ATOL, err_msg=n)
    assert len(np.unique(np.round(jloss, 6))) > 1  # the members really differ


def test_init_statistics_match_the_reference(ref):
    """Each leaf's mean and std over 64 members: lecun-normal convolution
    and dense kernels (fan-in ``kh * kw * in``), zero biases, unit
    GroupNorm scales."""
    _, pop = ref
    want = convert.resnet_params_from_numpy(pop, device="cpu")
    got = TR.init_population(TR.ResNet(**NET), P_INIT, R.key(0), device="cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape and g.dtype == torch.float32, n
        w, g = w.numpy().astype(np.float64), g.numpy().astype(np.float64)
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        N = w.size
        assert abs(g.mean() - w.mean()) <= INIT_SIGMAS * w.std() * np.sqrt(2.0 / N), n
        assert abs(g.std() / w.std() - 1.0) <= INIT_SIGMAS / np.sqrt(N), n
        assert np.abs(g).max() <= np.abs(w).max() * 1.05, n  # truncated at 2 stds


def test_sharding_is_refused():
    """What ``mesh=`` still refuses: a data axis over processes (its
    gradient all-reduce would sit inside the captured step), a mesh that
    is not a RankMesh, an axis the mesh lacks, and widths that do not
    divide (the reference's sharding constraints refuse those too)."""
    net = TR.ResNet(**NET)
    with pytest.raises(NotImplementedError, match="item 15c, part 6"):
        TR.make_population_train_step(net, mesh=RankMesh((2, 2), ("trial", "cand"), range(4)),
                                      device="cpu")
    with pytest.raises(TypeError, match="RankMesh"):
        TR.population_objective(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="data_axis 'cand' is not an axis"):
        TR.make_population_train_step(net, mesh=virtual_mesh(2, "trial"), device="cpu")
    # a population of one does not divide over two trial ranks
    with pytest.raises(ValueError, match="divide by the 'trial' mesh axis size 2"):
        TR.population_objective(n_steps=1, batch_size=16, image_size=8, device="cpu",
                                mesh=virtual_mesh((2, 4), ("trial", "cand")))({"lr": 0.05,
                                                                              "wd": 1e-4})


def test_population_step_on_a_mesh(ref, batch):
    """``mesh=virtual_mesh((2, 4), ("trial", "cand"))`` places four members
    on two trial ranks and the 8 images on four data ranks, as the
    reference's GSPMD constraints do: the step is bitwise the step without
    a mesh, and both hold the reference's unsharded step within the
    file's tolerances (``population_objective(mesh=)`` runs this step:
    its placement is checked in ``test_sharding_is_refused``)."""
    lr = np.array([0.3, 0.1, 0.03, 0.01], np.float32)
    wd = np.array([1e-5, 1e-4, 1e-3, 1e-2], np.float32)
    mesh = virtual_mesh((2, 4), ("trial", "cand"))
    _, (want, got), (_, got_mom) = _steps(ref, batch, 4, 1, lr, wd, mesh=mesh)
    # the same step without a mesh, the port alone
    plain = convert.resnet_params_from_numpy(jax.tree.map(lambda x: x[:4], ref[1]), device="cpu")
    plain_mom = {n: torch.zeros_like(v) for n, v in plain.items()}
    step = TR.make_population_train_step(TR.ResNet(**NET), device="cpu")
    plain, plain_mom, _ = step(plain, plain_mom, _t(lr), _t(wd), _t(batch[0]),
                               _t(batch[1], torch.int64))
    for n in want:
        assert torch.equal(got[n], plain[n]) and torch.equal(got_mom[n], plain_mom[n]), n
        np.testing.assert_allclose(got[n].detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=10 * PARAM_ATOL, err_msg=n)


def test_population_objective_trains():
    """The ``fmin`` objective on the tiny net: a sane lr beats a vanishing
    one after 2 steps (the reference's own check)."""
    obj = TR.population_objective(n_steps=2, batch_size=16, image_size=8, device="cpu")
    good, bad = obj({"lr": 0.05, "wd": 1e-4}), obj({"lr": 1e-5, "wd": 1e-4})
    assert np.isfinite(good) and np.isfinite(bad) and good < bad


def test_same_padding_matches_flax_at_odd_sizes():
    """The SAME split on an odd input at stride 2 ((1, 1)) and on an even
    one ((0, 1)), against ``flax.linen.Conv`` on the same kernel."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    for size in (7, 8):
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
        want = nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME", use_bias=False).apply(
            {"params": {"kernel": k}}, x)
        conv = TR._conv(3, 4, 3, 2)
        conv.weight.data = _t(k.transpose(3, 2, 0, 1))
        with torch.no_grad():
            got = TR._same_conv(_t(x.transpose(0, 3, 1, 2)), conv)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   rtol=0, atol=ACT_ATOL)
