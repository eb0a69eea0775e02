"""The tiny ``MultiHeadMask2FormerModel``'s pretrain steps (exact and point
mode), eval step and optimizer groups in the PyTorch port vs JAX's
``make_pretrain_step_mask2former`` / ``_make_m2f_eval_step`` / optax, on CPU
in fp32, from variables drawn with numpy and bridged with
``jax_params_to_torch`` (K9, the MSDeformAttn wrapper, the decoder and the
loss alone are in test_torch_port_mask2former.py).  Tolerances are fp32
summation order (1e-4 relative L2) unless a test says why.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samrs_tpu.seg.backbones.rvsa import ViTRVSA as JaxViTRVSA
from samrs_tpu.seg.decoders import mask2former as jm2f
from samrs_tpu.seg.frameworks import MultiHeadMask2FormerModel as JaxM2FModel
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.pretrain import _make_m2f_eval_step
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import make_pretrain_step_mask2former
from samrs_tpu_torch.seg.decoders import mask2former as m2f
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.trainer import (TrainState, mask2former_eval_step,
                                           pretrain_step_mask2former)
from test_torch_port_mask2former import (CLASSES, DEC, POINTS, SIZE, TOL, TinyPortM2F,
                                         jax_draws)
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables
from test_torch_port_train import _adam_state, _to_flax

BATCH = (2, 1, 2)
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5  # the default peak lr, past the warmup
# parameters with no true gradient: the key biases of every attention (softmax
# is blind to q.b_k), and the biases that shift every token of a map that
# feeds only a 1x1 conv + GroupNorm with one channel a group (the norm removes
# a per-channel shift): the neck's deconv biases and the last block's MLP
# output bias (that block's tokens are c3 and, max-pooled, c4).  Both packages
# return rounding noise there, which Adam turns into lr-sized steps; the step
# tests hold these gradients to zero on both sides, and a test checks that
# they are noise.
ZERO_GRAD = {"encoder.fpn1.3.bias": slice(None), "encoder.fpn2.0.bias": slice(None),
             "encoder.blocks.2.attn.qkv.bias": slice(32, 64),
             "encoder.blocks.2.mlp.fc2.bias": slice(None),
             **{f"seg_decoder.layer{i}_cross.k_proj.bias": slice(None) for i in range(3)},
             **{f"seg_decoder.layer{i}_self.qkv.bias": slice(32, 64) for i in range(3)}}


class TinyJaxM2F(JaxM2FModel):
    def setup(self):
        self.encoder = JaxViTRVSA(img_size=self.image_size, **TINY_RVSA)
        self.seg_decoder = jm2f.Mask2FormerDecoder(in_channels=(32,) * 4, **DEC)
        self.heads = [jm2f.Mask2FormerHead(nc, name=f"head_{i}")
                      for i, nc in enumerate(self.num_classes)]


def _m2f_batches(seed, size=SIZE):
    rng = np.random.default_rng(seed)
    out = []
    for b, nc in zip(BATCH, CLASSES):
        x = rng.normal(size=(b, size, size, 3)).astype(np.float32)
        y = rng.integers(0, nc - 1, (b, size, size)).astype(np.int32)  # the last class absent
        y[:, :7] = 255
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def m2f_variables():
    jm = TinyJaxM2F(num_classes=CLASSES, image_size=SIZE)
    xs0 = [jnp.zeros((1, SIZE, SIZE, 3))] * 3
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xs0, True))
    return jm, draw_variables(shapes, 50)["params"]


def _zero_grad_masks(model, params):
    """Port-layout 0/1 masks of ZERO_GRAD, hooked onto the port's gradients,
    and the same masks in flax layout."""
    keep = {}
    for n, p in model.named_parameters():
        m = np.ones(tuple(p.shape), np.float32)
        if n in ZERO_GRAD:
            m[ZERO_GRAD[n]] = 0.0
            p.register_hook(lambda g, m=torch.from_numpy(m): g * m)
        keep[n] = m
    # bridge a tree of leaf indices to find each flax leaf's port name
    flat = flax.traverse_util.flatten_dict(params)
    idx = {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(flat.items())}
    by_idx = {int(v.reshape(-1)[0]): n for n, v in jax_params_to_torch(
        flax.traverse_util.unflatten_dict(idx)).items()}
    return flax.traverse_util.unflatten_dict({k: _to_flax(keep[by_idx[i]], np.shape(v))
                                              for i, (k, v) in enumerate(flat.items())})


def _run_steps(m2f_variables, num_points, n_steps, heads=(0, 1, 2)):
    """n_steps Mask2Former pretrain steps on both sides from the same
    numpy-drawn state, with the batches of `heads` (the others skipped, as
    the JAX step skips a None batch; point mode: JAX's draws replayed); per
    step the heads' losses, the parameters and both Adam moments."""
    jm, params = m2f_variables
    model = TinyPortM2F()
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    jkeep = _zero_grad_masks(model, params)
    jsched = jax_optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(params, lambda c: jsched(c + OFFSET), weight_decay=0.05,
                                   grad_clip=5.0, layer_decay=0.9, num_layers=3)
    tx = optax.chain(optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda a, m: a * m, u, jkeep)), tx)
    jstate = JaxTrainState.create(params, {}, tx)
    jstep = make_pretrain_step_mask2former(jm, tx, CLASSES, num_points)
    psched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    opt = optim.Optimizer(model, lambda s: psched(s + OFFSET), weight_decay=0.05, grad_clip=5.0,
                          layer_decay=0.9, num_layers=3)
    state = TrainState(0, model, opt)
    names = {p: n for n, p in model.named_parameters()}
    dropout_rng = jax.random.PRNGKey(0)
    snaps = []
    for i in range(n_steps):
        b = [xy if h in heads else None for h, xy in enumerate(_m2f_batches(i))]
        draws = None
        if num_points:
            step_rng = jax.random.fold_in(dropout_rng, i)
            draws = [None if xy is None else jax_draws(jax.random.fold_in(step_rng, 1000 + h), 4,
                                                       len(xy[0]), len(xy[0]) * 8, num_points)
                     for h, xy in enumerate(b)]
        jstate, jmet = jstep(jstate, tuple(None if xy is None else tuple(map(jnp.asarray, xy))
                                           for xy in b), dropout_rng)
        pmet = pretrain_step_mask2former(
            state, [None if xy is None else tuple(map(torch.from_numpy, xy)) for xy in b], 0,
            CLASSES, num_points, draws)
        adam = _adam_state(jstate.opt_state)
        snaps.append(dict(
            jloss=[float(jmet[f"loss_{i}"]) for i in range(len(heads))],
            ploss=[float(pmet[f"loss_{h}"]) for h in heads],
            jparams=jax_params_to_torch(jstate.params),
            pparams={k: v.clone() for k, v in model.state_dict().items()},
            jmu=jax_params_to_torch(adam.mu), jnu=jax_params_to_torch(adam.nu),
            pmu={names[p]: s["exp_avg"].clone() for p, s in opt.opt.state.items()},
            pnu={names[p]: s["exp_avg_sq"].clone() for p, s in opt.opt.state.items()}))
    return snaps


def _check_snapshot(snap, moment_tol=TOL, whole_tol=TOL):
    """Losses to 1e-5, every parameter to TOL, both Adam moments over all
    parameters to `whole_tol` and each tensor's to `moment_tol`."""
    np.testing.assert_allclose(snap["ploss"], snap["jloss"], rtol=1e-5)
    assert set(snap["jparams"]) == set(snap["pparams"])
    for k, v in snap["jparams"].items():
        assert _rel_l2(snap["pparams"][k].numpy(), v.numpy()) <= TOL, k
    for moment in ("mu", "nu"):
        want, got = snap["j" + moment], snap["p" + moment]
        assert set(got) <= set(want)
        live = [k for k, v in want.items() if v.any()]
        for k in set(want) - set(live):  # a ZERO_GRAD tensor or a skipped head: no moment
            assert k not in got or not got[k].any(), (moment, k)
        for k in live:
            assert _rel_l2(got[k].numpy(), want[k].numpy()) <= moment_tol, (moment, k)
        whole = _rel_l2(np.concatenate([got[k].numpy().ravel() for k in live]),
                        np.concatenate([want[k].numpy().ravel() for k in live]))
        assert whole <= whole_tol, (moment, whole)


@pytest.fixture(scope="module")
def exact_run(m2f_variables):
    return _run_steps(m2f_variables, None, 3)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_m2f_steps_match_jax_exact_mode(exact_run, n_steps):
    """Per-head losses, parameters and both Adam moments after one and three
    steps of the full-mask loss (layer-decay AdamW, clip 5, lr > 0).

    After three steps the moments are held at 5e-2, the parameters and
    losses as after one: the first update moves the RVSA sampling nets by
    ~3e-6 apart on the two sides, K8's coordinate derivative is one-sided
    (it jumps at integer coordinates), and taps that cross one change their
    gradient by whole values; Adam's moments carry that (worst 3e-2 at step
    3), its normalised update does not (parameters within 2e-5).  No
    attention-mask bit and no assignment differs between the two states."""
    tol = TOL if n_steps == 1 else 5e-2
    _check_snapshot(exact_run[n_steps - 1], tol, tol)


def test_m2f_step_matches_jax_point_mode(m2f_variables):
    """One step of the point-sampled loss on the FAST head's batch (16
    points; JAX's draws replayed through the seam): the shared matching
    points (K8), the uncertainty candidates and the loss points (K9).  One
    head keeps JAX's compile of the step short.  The moments over all
    parameters are held at 1e-4, each tensor's at 1.2e-3: a few small
    gradients (biases, the RVSA sampling nets' through K8's coordinate
    derivative) are sums whose terms largely cancel, and with 16 points a
    mask their fp32 summation order shows at up to 3.75e-4 (the RVSA
    sampling-angle bias's first moment), the same with 1 or 8 torch threads:
    the bound keeps a 3x margin over it."""
    _check_snapshot(_run_steps(m2f_variables, POINTS, 1, heads=(2,))[0], 1.2e-3)


def test_m2f_zero_gradient_parameters_are_noise(m2f_variables):
    """The ZERO_GRAD coordinates of the summed three-head exact loss are
    rounding noise against the whole gradient's norm (so masking them in the
    step tests hides nothing)."""
    _, params = m2f_variables
    model = TinyPortM2F()
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    model.train()
    b = _m2f_batches(0)
    outs = model([torch.from_numpy(x) for x, _ in b])
    sum(sum(m2f.mask2former_loss(o, torch.from_numpy(y), nc).values())
        for o, (_, y), nc in zip(outs, b, CLASSES)).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    for k, sl in ZERO_GRAD.items():
        assert float(grads[k][sl].abs().max()) <= 1e-6 * total, k


def test_m2f_eval_step_matches_jax(m2f_variables):
    jm, params = m2f_variables
    model = TinyPortM2F()
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    for head, (x, y) in list(enumerate(_m2f_batches(7)))[2:]:  # one head: one JAX compile
        want = _make_m2f_eval_step(jm, CLASSES[head], head)(params, {}, jnp.asarray(x),
                                                              jnp.asarray(y))
        got = mask2former_eval_step(model, torch.from_numpy(x), torch.from_numpy(y),
                                    CLASSES[head], head)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_optimizer_groups_match_optax_for_mask2former(m2f_variables):
    """Every decoder parameter gets layer id num_layers + 1 (lr scale 1) and
    the weight-decay mask of JAX's ``no_weight_decay``."""
    _, params = m2f_variables
    scales = jax_params_to_torch(jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, s, np.float32),
        jax_optim.layer_decay_scales(params, 0.9, 3), params))
    decay = jax_params_to_torch(jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(v.shape, float(not jax_optim.no_weight_decay(
            jax_optim._path_str(p), v)), np.float32), params))
    model = TinyPortM2F()
    for name, p in model.named_parameters():
        assert optim.layer_decay_scale(name, 0.9, 3) == pytest.approx(
            float(scales[name].reshape(-1)[0]), rel=1e-6), name
        assert (not optim.no_weight_decay(name, p)) == bool(decay[name].reshape(-1)[0]), name
        if not name.startswith("encoder."):
            assert optim.vit_layer_id(name, 3) == 4, name
