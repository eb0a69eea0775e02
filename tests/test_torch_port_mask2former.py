"""PyTorch port of Mask2Former pretraining (K9, the MSDeformAttn wrapper over
K8, the Mask2Former decoder, loss and step) vs the JAX package, on CPU in fp32.

K9's plain version is held against the Pallas point sampler in interpret
mode and the MSDeformAttn wrapper against ``ms_deform_attn_pallas`` in
interpret mode and ``sampling.ms_deform_attn``, forward and VJP.  The
decoder and the loss (both modes; the point mode with JAX's random draws fed
through the loss's ``draw`` seam) run against flax on variables drawn with
numpy and bridged with ``jax_params_to_torch``; the full-size bridge, the
seeded init and ``run_pretrain`` end to end.  The tiny
``MultiHeadMask2FormerModel``'s pretrain and eval steps against JAX's are in
test_torch_port_mask2former_steps.py.  Tolerances are fp32 summation order
(1e-4 relative L2, as the other port tests) unless a test says why.
"""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from samrs_tpu.kernels import sampling as jax_sampling
from samrs_tpu.kernels.bilinear_gather import _make_point_sampler, ms_deform_attn_pallas
from samrs_tpu.seg.decoders import mask2former as jm2f
from samrs_tpu.seg.frameworks import MultiHeadMask2FormerModel as JaxM2FModel
from samrs_tpu_torch.core.config import DataConfig, OptimConfig, PretrainConfig
from samrs_tpu_torch.data.datasets import SegmentationDataset
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.kernels import _build, bilinear_gather
from samrs_tpu_torch.nn.layers import resize_bilinear
from samrs_tpu_torch.seg.backbones.rvsa import ViTRVSA
from samrs_tpu_torch.seg.decoders import mask2former as m2f
from samrs_tpu_torch.seg.frameworks import (MultiHeadMask2FormerModel,
                                            build_multihead_mask2former_model)
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train.pretrain import run_pretrain
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables
from test_torch_port_train import _make_seg_dataset

TOL = 1e-4  # fp32 both sides; only summation order differs
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- K9 ----


def _k9_inputs(rng, N, H, W, K, integer=False):
    img = rng.normal(size=(N, H, W)).astype(np.float32)
    if integer:  # every point on a pixel centre, some on the last row / column and off the map
        fx = rng.integers(-1, W + 1, (N, K)).astype(np.float32)
        fy = rng.integers(-1, H + 1, (N, K)).astype(np.float32)
    else:  # generic, some points off the map
        fx = rng.uniform(-2.5, W + 1.5, (N, K)).astype(np.float32)
        fy = rng.uniform(-2.5, H + 1.5, (N, K)).astype(np.float32)
    dout = rng.normal(size=(N, K)).astype(np.float32)
    return img, fx, fy, dout


def _k9_jax(img, fx, fy, dout):
    out, vjp = jax.vjp(_make_point_sampler(True), *map(jnp.asarray, (img, fx, fy)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _k9_port(img, fx, fy, dout):
    ts = [torch.from_numpy(a).requires_grad_() for a in (img, fx, fy)]
    out = bilinear_gather.point_sample(*ts)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("N,H,W,K", [(3, 7, 9, 200), (2, 16, 16, 513)])
def test_k9_plain_matches_pallas_interpret(N, H, W, K):
    """Forward and VJP (dimg, dfx, dfy); K not a multiple of the Pallas
    block, points partly off the map."""
    args = _k9_inputs(np.random.default_rng(K), N, H, W, K)
    want = _k9_jax(*args)
    got = _k9_port(*args)
    for name, g, w in zip(("out", "dimg", "dfx", "dfy"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= TOL, (name, _rel_l2(g, w))


def test_k9_integer_coordinates_equal_pallas_interpret():
    """Points exactly on pixels and off the map: the one-sided coordinate
    derivative equals the TPU kernel's _dhat (a convention that differed
    would be off by whole values); equal up to fp32 summation order."""
    img, fx, fy, dout = args = _k9_inputs(np.random.default_rng(3), 2, 5, 6, 60, integer=True)
    want = _k9_jax(*args)
    got = _k9_port(*args)
    for name, g, w in zip(("out", "dimg", "dfx", "dfy"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    at = lambda n, y, x: img[n, y, x] if 0 <= y < 5 and 0 <= x < 6 else 0.0
    n, k = 1, 7
    x, y = int(fx[n, k]), int(fy[n, k])
    assert abs(got[2][n, k] - dout[n, k] * (at(n, y, x + 1) - at(n, y, x))) <= 1e-5
    assert abs(got[3][n, k] - dout[n, k] * (at(n, y + 1, x) - at(n, y, x))) <= 1e-5


def test_k9_plain_row_slices_equal(monkeypatch):
    """The plain version's row slices (its bound on int64 transients) give the
    same values and gradients as one pass."""
    args = _k9_inputs(np.random.default_rng(4), 5, 6, 7, 30)
    want = _k9_port(*args)
    monkeypatch.setattr(bilinear_gather, "_PS_POINTS", 60)  # two rows a pass
    got = _k9_port(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_k9_coordinate_gradient_skipped_when_not_asked():
    img, fx, fy, dout = _k9_inputs(np.random.default_rng(5), 2, 4, 5, 9)
    dimg, dfx, dfy = bilinear_gather.point_sample_plain_bwd(
        *map(torch.from_numpy, (img, fx, fy, dout)), coords_grad=False)
    assert dfx is None and dfy is None
    assert _rel_l2(dimg.numpy(), _k9_jax(img, fx, fy, dout)[1]) <= TOL


def test_k9_cuda_path_refuses_cpu_tensors_and_cpu_never_counts(monkeypatch):
    """The kernel entry points take CUDA tensors only; a CPU call runs the
    plain version, builds nothing and counts no launch."""
    img, f = torch.zeros(1, 4, 4), torch.zeros(1, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bilinear_gather.point_sample_fwd_cuda(img, f, f)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bilinear_gather.point_sample_bwd_cuda(img, f, f, f)

    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    for name in ("fwd_launches", "bwd_launches", "ps_fwd_launches", "ps_bwd_launches"):
        monkeypatch.setattr(bilinear_gather, name, 0)
    _k9_port(*_k9_inputs(np.random.default_rng(6), 2, 4, 5, 9))
    v = torch.zeros(1, 5, 2, 4, requires_grad=True)
    bilinear_gather.ms_deform_attn(v, [(1, 5)], torch.rand(1, 3, 2, 1, 2, 2),
                                   torch.rand(1, 3, 2, 1, 2)).sum().backward()
    assert (bilinear_gather.fwd_launches, bilinear_gather.bwd_launches,
            bilinear_gather.ps_fwd_launches, bilinear_gather.ps_bwd_launches) == (0, 0, 0, 0)


# -------------------------------------------------------------- MSDA ----

LEVELS = [(3, 4), (2, 2), (5, 3)]


def _msda_inputs(rng, B=2, Q=7, nH=2, D=4, P=3):
    S = sum(h * w for h, w in LEVELS)
    value = rng.normal(size=(B, S, nH, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, nH, len(LEVELS), P, 2)).astype(np.float32)
    wts = rng.uniform(0.1, 1.0, (B, Q, nH, len(LEVELS), P)).astype(np.float32)
    dout = rng.normal(size=(B, Q, nH * D)).astype(np.float32)
    return value, loc, wts, dout


@pytest.mark.parametrize("oracle", ["pallas_interpret", "sampling"])
def test_ms_deform_attn_matches_jax(oracle):
    """The wrapper (plain on the CPU) and its ``plain=True`` route against
    ``ms_deform_attn_pallas`` in interpret mode and against the XLA oracle
    ``sampling.ms_deform_attn``: forward and VJP (value, locations, weights)."""
    args = _msda_inputs(np.random.default_rng(11))
    if oracle == "pallas_interpret":
        f = lambda v, l, w: ms_deform_attn_pallas(v, LEVELS, l, w, interpret=True)
    else:
        f = lambda v, l, w: jax_sampling.ms_deform_attn(v, LEVELS, l, w)
    out, vjp = jax.vjp(f, *map(jnp.asarray, args[:3]))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(args[3]))]
    for plain in (False, True):
        ts = [torch.from_numpy(a).requires_grad_() for a in args[:3]]
        got = bilinear_gather.ms_deform_attn(ts[0], LEVELS, ts[1], ts[2], plain=plain)
        got.backward(torch.from_numpy(args[3]))
        got = [got.detach().numpy()] + [t.grad.numpy() for t in ts]
        for name, g, w in zip(("out", "dvalue", "dloc", "dweights"), got, want):
            assert g.shape == w.shape, name
            assert _rel_l2(g, w) <= TOL, (oracle, plain, name, _rel_l2(g, w))


def test_msdeformattn_module_matches_jax():
    """The module (value / offset / weight projections, softmax over levels x
    points, the rotated-grid offsets) on numpy-drawn variables, and its seeded
    init equal to the JAX module's initialisers."""
    from samrs_tpu.seg.backbones.vit_adapter import MSDeformAttnModule as JaxMSDA
    from samrs_tpu.seg.backbones.vit_adapter import _ref_points as jax_ref

    from samrs_tpu_torch.seg.backbones.vit_adapter import MSDeformAttnModule, _ref_points

    rng = np.random.default_rng(12)
    B, D = 2, 16
    S = sum(h * w for h, w in LEVELS)
    q = rng.normal(size=(B, S, D)).astype(np.float32)
    v = rng.normal(size=(B, S, D)).astype(np.float32)
    ref = np.broadcast_to(np.asarray(jax_ref(LEVELS))[:, :, None], (B, S, 3, 2)).copy()
    jmod = JaxMSDA(D, 3, 4, 2, 1.0)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(ref), jnp.asarray(v),
                     LEVELS)
    jvars = draw_variables(jax.eval_shape(lambda: init), 13)
    mod = MSDeformAttnModule(D, 3, 4, 2, 1.0)
    for variables in (jvars, jax.tree_util.tree_map(np.asarray, init)):
        want = np.asarray(jmod.apply(variables, jnp.asarray(q), jnp.asarray(ref), jnp.asarray(v),
                                     LEVELS))
        sd = {k.removeprefix("m."): t for k, t in jax_params_to_torch(
            {"m": variables["params"]}).items()}
        mod.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = mod(*map(torch.from_numpy, (q, ref, v)), LEVELS).numpy()
        assert _rel_l2(got, want) <= TOL
    # the JAX initialisers of the sampling nets, and the reference points
    mod.reset_sampling()
    for name, t in mod.state_dict().items():
        if name.startswith(("sampling_offsets", "attention_weights")):
            np.testing.assert_array_equal(t.numpy(), sd[name].numpy(), err_msg=name)
    np.testing.assert_allclose(_ref_points(LEVELS).numpy(), np.asarray(jax_ref(LEVELS)),
                               rtol=0, atol=1e-7)


# ------------------------------------------------------------ resizes ----


@pytest.mark.parametrize("hw_in,hw_out", [((56, 56), (7, 7)), ((56, 56), (14, 14)),
                                          ((56, 56), (28, 28)), ((13, 17), (4, 6))])
def test_attention_mask_resize_matches_jax(hw_in, hw_out):
    """The attention mask's shrink is jax.image.resize's antialiased bilinear
    (a triangle widened by the scale), which ``F.interpolate(bilinear)`` is
    not; the thresholded bits ``sigmoid(m) < 0.5`` are equal."""
    x = np.random.default_rng(hw_out[0]).normal(size=(2, 3, *hw_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *hw_out), "bilinear"))
    got = m2f.resize_bilinear_antialias(torch.from_numpy(x), hw_out)
    assert _rel_l2(got.numpy(), want) <= 1e-6
    bits = lambda m: 1.0 / (1.0 + np.exp(-np.asarray(m, np.float64))) < 0.5
    np.testing.assert_array_equal(torch.sigmoid(got).numpy() < 0.5, bits(want))
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), hw_out, mode="bilinear",
                                            align_corners=False)
    assert _rel_l2(plain.numpy(), want) > 1e-2


@pytest.mark.parametrize("hw_in,hw_out", [((224, 224), (56, 56)), ((224, 224), (50, 37)),
                                          ((37, 53), (16, 16))])
def test_label_nearest_resize_matches_jax(hw_in, hw_out):
    """The label downsample to the mask grid: jax's half-pixel nearest
    (torch's ``nearest-exact``); torch's ``nearest`` differs at a
    non-integer ratio."""
    y = np.random.default_rng(hw_out[1]).integers(0, 9, (2, *hw_in)).astype(np.int64)
    want = np.asarray(jax.image.resize(jnp.asarray(y, jnp.float32), (2, *hw_out), "nearest"))
    got = m2f.resize_nearest(torch.from_numpy(y), hw_out).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    exact = torch.nn.functional.interpolate(torch.from_numpy(y)[:, None].float(), hw_out,
                                            mode="nearest-exact")[:, 0].numpy()
    np.testing.assert_array_equal(exact, want)
    if hw_in[0] % hw_out[0]:
        floor = torch.nn.functional.interpolate(torch.from_numpy(y)[:, None].float(), hw_out,
                                                mode="nearest")[:, 0].numpy()
        assert (floor != want).any()


@pytest.mark.parametrize("antialias,hw_in,hw_out", [(False, (28, 28), (56, 56)),
                                                    (False, (5, 3), (20, 20)),
                                                    (True, (56, 56), (224, 224))])
def test_upsamples_match_jax(antialias, hw_in, hw_out):
    """The pixel decoder's top-down upsample (antialias=False) and the eval
    step's upsample to the labels (jax's default antialias, which an
    upscale does not use) are the port's ``resize_bilinear``."""
    x = np.random.default_rng(2).normal(size=(2, 3, *hw_in)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, *hw_out), "bilinear", antialias=antialias)
    got = resize_bilinear(torch.from_numpy(x), hw_out)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-6


def test_groupnorm_eps_matches_flax():
    """flax's GroupNorm eps is 1e-6 (torch's default 1e-5): on a channel
    group whose variance is ~eps the two defaults part."""
    from flax import linen as fnn

    x = (1e-3 * np.random.default_rng(3).normal(size=(2, 5, 5, 64))).astype(np.float32)
    jgn = fnn.GroupNorm(num_groups=32)
    jv = draw_variables(jax.eval_shape(lambda: jgn.init(jax.random.PRNGKey(0), x)), 4)
    want = np.asarray(jgn.apply(jv, jnp.asarray(x)))
    for eps, ok in ((1e-6, True), (1e-5, False)):
        gn = nn.GroupNorm(32, 64, eps=eps)
        with torch.no_grad():
            gn.weight.copy_(torch.from_numpy(np.asarray(jv["params"]["scale"])))
            gn.bias.copy_(torch.from_numpy(np.asarray(jv["params"]["bias"])))
            got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert (_rel_l2(got, want) <= 1e-5) == ok, (eps, _rel_l2(got, want))


# ------------------------------------------------------------ decoder ----

DEC = dict(embed_dim=32, num_queries=8, num_decoder_layers=3, num_heads=2)
DEC_IN = (16, 16, 32, 32)
DEC_SIZES = [(16, 16), (8, 8), (4, 4), (2, 2)]


@pytest.fixture(scope="module")
def tiny_decoder():
    """(flax decoder, numpy-drawn variables, port decoder, NHWC features)."""
    jdec = jm2f.Mask2FormerDecoder(in_channels=DEC_IN, **DEC)
    rng = np.random.default_rng(20)
    feats = [np.zeros((2, 64, 64, 3), np.float32)] + [
        rng.normal(size=(2, h, w, c)).astype(np.float32) for (h, w), c in zip(DEC_SIZES, DEC_IN)]
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0),
                                              [jnp.asarray(f) for f in feats], False))
    jvars = draw_variables(shapes, 21)
    dec = m2f.Mask2FormerDecoder(DEC_IN, **DEC)
    sd = {k.removeprefix("seg_decoder."): v for k, v in jax_params_to_torch(
        {"seg_decoder": jvars["params"]}).items()}
    dec.load_state_dict(sd, strict=True)
    return jdec, jvars, dec, feats


def test_decoder_matches_flax(tiny_decoder):
    """Every output (the initial queries' and 3 layers': query features and
    16x16 mask logits) and the attention-mask bits each layer derives from
    the previous output (counted: 0 differ)."""
    jdec, jvars, dec, feats = tiny_decoder
    want = jax.jit(lambda v, f: jdec.apply(v, f, False))(jvars, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = dec([torch.from_numpy(f).permute(0, 3, 1, 2).contiguous() for f in feats])
    assert len(got) == len(want) == 4
    for i, ((gq, gm), (wq, wm)) in enumerate(zip(got, want)):
        assert gm.shape == wm.shape == (2, 8, 16, 16)
        assert _rel_l2(gq.detach().numpy(), wq) <= TOL, (i, "queries")
        assert _rel_l2(gm.numpy(), wm) <= TOL, (i, "masks")
    differ = 0
    for layer in range(3):  # the scale of layer l is DEC_SIZES[3 - l % 3]: 2x2, 4x4, 8x8
        hw = DEC_SIZES[3 - layer % 3]
        jb = jax.nn.sigmoid(jax.image.resize(want[layer][1], (2, 8, *hw), "bilinear")) < 0.5
        pb = torch.sigmoid(m2f.resize_bilinear_antialias(got[layer][1], hw)) < 0.5
        differ += int((pb.numpy() != np.asarray(jb)).sum())
    assert differ == 0


def test_sine_positional_encoding_matches_jax():
    for h, w, d in ((7, 7, 256), (5, 3, 32)):
        want = np.asarray(jm2f.sine_positional_encoding(h, w, d))
        got = m2f.sine_positional_encoding(h, w, d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --------------------------------------------------------------- loss ----


def test_hungarian_match_matches_jax_and_scipy():
    """scipy on the host (the port) against the JAX device solver: the same
    optimal total and, where the optimum is unique, the same assignment.
    Only the 1e6-cost invalid gt slots tie; which query takes one does not
    change the loss (the loss masks unmatched and invalid slots alike)."""
    rng = np.random.default_rng(30)
    for Q, G in ((8, 5), (100, 37), (4, 9), (3, 3)):
        cost = (10 * rng.random((3, Q, G))).astype(np.float32)
        cost[0, :, G // 2:] = 1e6  # invalid gt slots
        got = m2f.hungarian_match(torch.from_numpy(cost)).numpy()
        want = np.asarray(jm2f.hungarian_match(jnp.asarray(cost)))
        for b in range(3):
            np.testing.assert_array_equal(got[b], jm2f._hungarian_host(cost[b]))
            rows = np.nonzero(got[b] >= 0)[0]
            wrows = np.nonzero(want[b] >= 0)[0]
            assert len(rows) == len(wrows) == min(Q, G)
            np.testing.assert_allclose(cost[b, rows, got[b, rows]].sum(),
                                       cost[b, wrows, want[b, wrows]].sum(), rtol=1e-6)
            valid = (got[b] >= 0) & (got[b] < (G // 2 if b == 0 else G))
            np.testing.assert_array_equal(got[b][valid], want[b][valid])


def jax_draws(rng, n_layers, B, N, num_points, oversample=3.0, importance=0.75):
    """The JAX loss's uniform draws (``fold_in(rng, layer)``, then its splits)
    as a ``draw`` seam for the port's loss."""
    out = {}
    n_rand = num_points - int(importance * num_points)
    for li in range(n_layers):
        r_match, r_loss = jax.random.split(jax.random.fold_in(rng, li))
        r1, r2 = jax.random.split(r_loss)
        out["match", li] = jax.random.uniform(r_match, (B, num_points, 2))
        out["candidates", li] = jax.random.uniform(r1, (N, int(num_points * oversample), 2))
        out["random", li] = jax.random.uniform(r2, (N, n_rand, 2))

    def draw(kind, layer, shape):
        a = np.asarray(out[kind, layer])
        assert a.shape == tuple(shape), (kind, layer, a.shape, shape)
        return torch.from_numpy(a.copy())

    return draw


def test_point_sample_shared_matches_jax():
    rng = np.random.default_rng(31)
    masks = rng.normal(size=(2, 7, 9, 11)).astype(np.float32)
    pts = rng.random((2, 40, 2)).astype(np.float32)
    want = np.asarray(jm2f.point_sample_shared(jnp.asarray(masks), jnp.asarray(pts)))
    for plain in (False, True):
        got = m2f.point_sample_shared(torch.from_numpy(masks), torch.from_numpy(pts), plain)
        assert got.shape == (2, 7, 40)
        assert _rel_l2(got.numpy(), want) <= 1e-6


def test_uncertain_point_coords_with_replayed_draws():
    """The JAX draws through the seam: the same candidates, the same most
    uncertain subset (top-k of -|logit|) and the same top-up."""
    rng = np.random.default_rng(32)
    logits = rng.normal(size=(6, 9, 9)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm2f.uncertain_point_coords(key, jnp.asarray(logits), 16))
    r1, r2 = jax.random.split(key)
    cand = np.array(jax.random.uniform(r1, (6, 48, 2)))
    top = np.array(jax.random.uniform(r2, (6, 4, 2)))
    draw = lambda kind, layer, shape: torch.from_numpy({"candidates": cand, "random": top}[kind])
    got = m2f.uncertain_point_coords(torch.from_numpy(logits), 16, draw, 0).numpy()
    assert got.shape == (6, 16, 2)
    np.testing.assert_array_equal(got, want)


def _loss_case(seed, B=2, Q=8, C=5, H4=16, size=64, n_layers=3):
    rng = np.random.default_rng(seed)
    outs = [(rng.normal(size=(B, Q, C + 1)).astype(np.float32),
             (3 * rng.normal(size=(B, Q, H4, H4))).astype(np.float32)) for _ in range(n_layers)]
    labels = rng.integers(0, C - 1, (B, size, size)).astype(np.int64)  # class C-1 absent: invalid
    labels[:, :5] = 255
    return outs, labels


@pytest.mark.parametrize("num_points", [None, 16])
def test_mask2former_loss_and_gradients_match_jax(num_points):
    """Both modes, the three terms and the gradients of their sum with
    respect to every class and mask logit; the point mode with the JAX
    draws replayed.  JAX assigns with its device solver, the port with
    scipy: equal losses show the invalid-slot ties change nothing."""
    outs, labels = _loss_case(40)
    B, Q = outs[0][0].shape[:2]
    key = jax.random.PRNGKey(7)

    def jloss(o):
        d = jm2f.mask2former_loss(o, jnp.asarray(labels), 5, num_points=num_points,
                                  rng=key if num_points else None)
        return d["loss_cls"] + d["loss_mask"] + d["loss_dice"], d

    (jl, jd), jg = jax.value_and_grad(jloss, has_aux=True)(
        [tuple(map(jnp.asarray, o)) for o in outs])
    ts = [tuple(torch.from_numpy(a).requires_grad_() for a in o) for o in outs]
    draw = jax_draws(key, len(outs), B, B * Q, num_points) if num_points else None
    d = m2f.mask2former_loss(ts, torch.from_numpy(labels), 5, num_points=num_points, draw=draw)
    for k in ("loss_cls", "loss_mask", "loss_dice"):
        assert float(d[k].detach()) == pytest.approx(float(jd[k]), rel=1e-5), k
    (d["loss_cls"] + d["loss_mask"] + d["loss_dice"]).backward()
    for (tc, tm), (gc, gm) in zip(ts, jg):
        assert _rel_l2(tc.grad.numpy(), gc) <= TOL
        assert _rel_l2(tm.grad.numpy(), gm) <= TOL


def test_mask2former_loss_point_mode_needs_draws():
    outs, labels = _loss_case(41)
    ts = [tuple(map(torch.from_numpy, o)) for o in outs]
    with pytest.raises(ValueError, match="generator or draws"):
        m2f.mask2former_loss(ts, torch.from_numpy(labels), 5, num_points=16)
    d = m2f.mask2former_loss(ts, torch.from_numpy(labels), 5, num_points=16,
                             generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in d.values())


def test_predict_and_semantic_to_instances_match_jax():
    outs, labels = _loss_case(42)
    cls, masks = outs[-1]
    want = np.asarray(jm2f.mask2former_predict(jnp.asarray(cls), jnp.asarray(masks), 5))
    got = m2f.mask2former_predict(torch.from_numpy(cls), torch.from_numpy(masks), 5).numpy()
    assert _rel_l2(got, want) <= 1e-6
    wm, wv = jm2f.semantic_to_instances(jnp.asarray(labels), 5)
    gm, gv = m2f.semantic_to_instances(torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------- the model ----

SIZE = 80  # 5x5 tokens: c1 20x20 (the mask grid), c2 10x10, c3 5x5, c4 2x2
CLASSES = (3, 4, 5)
POINTS = 16


class TinyPortM2F(MultiHeadMask2FormerModel):
    """The port's MultiHeadMask2FormerModel with the width-32 RVSA trunk of
    the pretrain tests and the tiny decoder (embed 32, 8 queries, 3 layers,
    2 heads); no drop-path (the two packages' random streams differ)."""

    def __init__(self, num_classes=CLASSES, size=SIZE):
        nn.Module.__init__(self)
        self.backbone, self.decoder, self.image_size = "vit_b_rvsa", "mask2former", size
        self.use_kernels = True
        self.num_classes = tuple(num_classes)
        self.encoder = ViTRVSA(img_size=size, **TINY_RVSA)
        self.seg_decoder = m2f.Mask2FormerDecoder((32,) * 4, **DEC)
        self.heads = nn.ModuleList(m2f.Mask2FormerHead(32, nc) for nc in self.num_classes)


def test_bridge_loads_the_full_size_model_strictly():
    """flax's vit_b_rvsa + Mask2Former tree (full width, 3 heads) bridges to
    the port's model key for key and shape for shape."""
    jm = JaxM2FModel(num_classes=(18, 20, 37), image_size=224)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, 224, 224, 3))] * 3, True))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    model = MultiHeadMask2FormerModel(num_classes=(18, 20, 37), image_size=224)
    model.load_state_dict(jax_params_to_torch(params), strict=True)


def test_build_multihead_mask2former_model_init():
    """The seeded init keeps the JAX decoder's initialisers: zero offset
    kernels with the rotated-grid bias, zero attention weights, normal(1)
    embeddings, GroupNorm ones / zeros."""
    from samrs_tpu_torch.seg.backbones.vit_adapter import _grid_init

    model = build_multihead_mask2former_model(num_classes=(3,), image_size=32, device="cpu",
                                              num_queries=10, num_decoder_layers=2)
    pd = model.seg_decoder.pixel_decoder
    for i in range(6):
        attn = getattr(pd, f"encoder{i}_attn")
        assert not attn.sampling_offsets.weight.any() and not attn.attention_weights.weight.any()
        assert not attn.attention_weights.bias.any()
        np.testing.assert_array_equal(attn.sampling_offsets.bias.detach().numpy(),
                                      _grid_init(8, 3, 4))
    for p in (pd.level_embed, model.seg_decoder.query_feat, model.seg_decoder.query_embed):
        assert 0.8 < float(p.detach().std()) < 1.2
    assert bool((pd.output_conv_gn.weight == 1).all()) and not pd.output_conv_gn.bias.any()
    assert pd.output_conv_gn.eps == 1e-6


def test_run_pretrain_mask2former_end_to_end_and_resume(tmp_path, caplog):
    """``run_pretrain(decoder="mask2former", m2f_num_points=16)`` with the
    tiny model on two synthetic datasets: 4 iterations with an eval every 2,
    checkpoints, then a resume from ``last`` that restores the step and the
    weights."""
    size = 32
    roots = {n: _make_seg_dataset(tmp_path, n, size) for n in ("sota", "sior")}
    ds = lambda split, aug: {n: SegmentationDataset(str(r), str(r / "images"), str(r / "labels"),
                                                    split=split, transform=aug, val_images=8)
                             for n, r in roots.items()}
    cfg = PretrainConfig(decoder="mask2former", m2f_num_points=POINTS, total_iters=4,
                         eval_interval=2, seed=0, device="cpu",
                         data=DataConfig(root=str(tmp_path), datasets=("sota", "sior"),
                                         image_size=size, batch_size=16, num_workers=2,
                                         val_images=8),
                         optim=OptimConfig(lr=1e-3, warmup_iters=2),
                         ckpt_dir=str(tmp_path / "ckpt"))
    model = TinyPortM2F((18, 20), size)
    trn = ds("trn", TrainAugment(size, rng=np.random.default_rng(0)))
    val = ds("val", EvalAugment(size))
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.pretrain"):
        state = run_pretrain(cfg, model=model, datasets_trn=trn, datasets_val=val)
    assert state.step == 4
    for f in ("last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"):
        assert os.path.exists(tmp_path / "ckpt" / f), f
    vals = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val[")]
    assert len(vals) == 4 and {v.split("]")[0] for v in vals} == {"val[sota", "val[sior"}
    losses = [r.getMessage() for r in caplog.records if r.getMessage().startswith("iter 4/4")]
    assert losses and np.isfinite(float(losses[0].split("loss ")[1].split()[0]))
    after = {k: v.clone() for k, v in model.state_dict().items()}

    resumed = TinyPortM2F((18, 20), size)
    cfg2 = PretrainConfig(**{**cfg.__dict__, "resume": "last", "total_iters": 5})
    state2 = run_pretrain(cfg2, model=resumed, datasets_trn=trn, datasets_val=val, max_iters=4)
    assert state2.step == 4
    for k, v in after.items():
        assert torch.equal(resumed.state_dict()[k], v), k
    assert run_pretrain(cfg2, model=resumed, datasets_trn=trn, datasets_val=val).step == 5


def test_new_modules_import_no_jax():
    """The modules this slice adds pull in no JAX (the package-wide guard is
    in test_torch_port_sam.py)."""
    code = ("import sys\n"
            "import samrs_tpu_torch.seg.decoders.mask2former, samrs_tpu_torch.seg.frameworks\n"
            "import samrs_tpu_torch.seg.backbones.vit_adapter, samrs_tpu_torch.train.pretrain\n"
            "bad = [k for k in sys.modules\n"
            "       if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'samrs_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
