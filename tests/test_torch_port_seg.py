"""PyTorch port of the segmentation model (samrs_tpu_torch.seg, K8) vs the
JAX package, on CPU in fp32.

K8's, K10's and K11's plain versions are held against the JAX Pallas
kernels in interpret mode, forward and VJP; the K10 / K11 autograd Functions'
backward (the plain version's VJP, recomputed) runs here with the kernel's
forward replaced by its plain version.  The RVSA attention, the RVSA trunk with its neck, and the
UperNet head run on flax variables whose every leaf is drawn with numpy
(none left at zero: the sampling nets too, so the sampling coordinates are
generic), bridged with ``jax_params_to_torch`` and loaded strictly.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.bilinear_gather import grid_sample_pallas
from samrs_tpu.kernels.flash_attention import flash_attention_plain as jax_flash_plain
from samrs_tpu.kernels.fused_mlp import fused_mlp as jax_fused_mlp
from samrs_tpu.nn import layers as jax_layers
from samrs_tpu.kernels.bilinear_gather import sample_weighted as jax_sample_weighted
from samrs_tpu.seg.backbones.rvsa import RotatedVariedSizeWindowAttention as JaxRVSA
from samrs_tpu.seg.backbones.rvsa import ViTRVSA as JaxViTRVSA
from samrs_tpu.seg.backbones.vit_common import FullAttentionRelPos as JaxFullAttention
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.port import load_torch_rvsa_backbone
from samrs_tpu_torch.kernels import bilinear_gather, flash_attention, fused_mlp
from samrs_tpu_torch.seg.backbones.rvsa import RotatedVariedSizeWindowAttention, ViTRVSA
from samrs_tpu_torch.seg.backbones.vit_common import FullAttentionRelPos
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.port import jax_params_to_torch

TOL = 1e-4  # fp32 both sides; only summation order differs
TINY_RVSA = dict(embed_dim=32, depth=3, num_heads=2, window_size=7, interval=3,
                 out_indices=(0, 1, 2, 2), drop_path_rate=0.0, use_abs_pos_emb=False)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def draw_variables(shapes, seed: int):
    """Every leaf of a flax variable tree drawn with numpy, none left at zero."""
    flat = flax.traverse_util.flatten_dict(shapes)
    rng = np.random.default_rng(seed)
    for k, s in sorted(flat.items()):
        v = rng.normal(size=s.shape).astype(np.float32)
        if k[-1] in ("scale", "var"):
            v = 1.0 + 0.1 * np.abs(v) if k[-1] == "var" else 1.0 + 0.1 * v
        elif k[-1] == "kernel":
            v = v * np.prod(s.shape[:-1]) ** -0.5
        else:
            v = 0.1 * v
        flat[k] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


# ---------------------------------------------------------------- K8 ----


def _k8_inputs(rng, BG, H, W, Gc, P, K, integer=False):
    xg = rng.normal(size=(BG, H, W * Gc)).astype(np.float32)
    if integer:  # every tap on a pixel centre, some on the last row/column
        fx = rng.integers(-1, W + 1, (BG, P, K)).astype(np.float32)
        fy = rng.integers(-1, H + 1, (BG, P, K)).astype(np.float32)
    else:  # generic coordinates, some out of bounds
        fx = rng.uniform(-2.5, W + 1.5, (BG, P, K)).astype(np.float32)
        fy = rng.uniform(-2.5, H + 1.5, (BG, P, K)).astype(np.float32)
    mask = rng.uniform(0.2, 1.0, (BG, P, K)).astype(np.float32)
    dout = rng.normal(size=(BG, P, Gc)).astype(np.float32)
    return xg, fx, fy, mask, dout


def _k8_jax(xg, fx, fy, mask, dout, Gc):
    f = lambda *a: jax_sample_weighted(*a, Gc, interpret=True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (xg, fx, fy, mask)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _k8_port(xg, fx, fy, mask, dout, Gc):
    ts = [torch.from_numpy(a).requires_grad_() for a in (xg, fx, fy, mask)]
    out = bilinear_gather.sample_weighted(*ts, Gc)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("K,P,Gc", [(1, 130, 8), (4, 37, 4)])
def test_k8_plain_matches_pallas_interpret(K, P, Gc):
    """Forward and VJP (dxg, dfx, dfy, dmask); P not a multiple of the
    Pallas block, taps partly off the map."""
    args = _k8_inputs(np.random.default_rng(K), 3, 6, 7, Gc, P, K)
    want = _k8_jax(*args, Gc)
    got = _k8_port(*args, Gc)
    for name, g, w in zip(("out", "dxg", "dfx", "dfy", "dmask"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= TOL, (name, _rel_l2(g, w))


def test_k8_integer_coordinates_equal_pallas_interpret():
    """Taps exactly on pixels: the one-sided coordinate derivative (slope -1
    for the tap at t in [0, 1), +1 at t in [-1, 0), none at t = 1) equals
    the TPU kernel's _dhat.  Equal up to fp32 summation order (a convention
    that differed would be off by whole values)."""
    Gc = 4
    args = _k8_inputs(np.random.default_rng(5), 2, 5, 6, Gc, 40, 2, integer=True)
    want = _k8_jax(*args, Gc)
    got = _k8_port(*args, Gc)
    for name, g, w in zip(("out", "dxg", "dfx", "dfy", "dmask"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    xg, fx, fy, mask, dout = args
    # the plain version's dfx is the floor formula: sum_c g * (X[y, x+1] - X[y, x])
    img = xg.reshape(2, 5, 6, Gc)
    b, p, k = 1, 3, 0
    x, y = int(fx[b, p, k]), int(fy[b, p, k])
    at = lambda yy, xx: img[b, yy, xx] if 0 <= yy < 5 and 0 <= xx < 6 else np.zeros(Gc)
    want_dfx = float(np.sum(mask[b, p, k] * dout[b, p] * (at(y, x + 1) - at(y, x))))
    assert abs(got[2][b, p, k] - want_dfx) <= 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_pallas_interpret(align_corners):
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 7, 2)).astype(np.float32)
    want = grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners,
                              interpret=True)
    got = bilinear_gather.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                                      align_corners=align_corners)
    assert got.shape == (2, 4, 7, 5)
    assert _rel_l2(got.numpy(), want) <= TOL


def test_resize_bilinear_batch_slices_equal(monkeypatch):
    """Resizes past the one-call element limit run in batch slices with the
    same values and gradients (the card's bilinear backward refuses 2^31
    output elements)."""
    from samrs_tpu_torch.nn import layers

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 3, 4, 6)).astype(np.float32))
    x.requires_grad_()
    want = layers.resize_bilinear(x, (8, 12))
    gw, = torch.autograd.grad(want.sin().sum(), x)
    monkeypatch.setattr(layers, "_MAX_INTERP", 2 * 3 * 8 * 12)
    got = layers.resize_bilinear(x, (8, 12))
    gg, = torch.autograd.grad(got.sin().sum(), x)
    assert torch.equal(got, want) and torch.equal(gg, gw)


def test_k8_cuda_path_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; the CPU goes to the plain version."""
    xg = torch.zeros(1, 2, 8)
    f = torch.zeros(1, 3, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bilinear_gather.sample_weighted_fwd_cuda(xg, f, f, f, 4)


# ------------------------------------------------------------ K10, K11 ----


def _vjp_port(fn, arrays, dout):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _vjp_jax(fn, arrays, dout):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _k10_inputs(N, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, N, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("N,d", [(64, 16), (256, 64), (196, 64), (196, 16)])
def test_k10_plain_matches_jax(N, d):
    """K10's plain version against ``flash_attention_plain``: the Pallas
    kernel in interpret mode where N has a query tile (64, 256), the XLA
    oracle where it has none (196); forward and VJP, fp32 at 1e-5."""
    q, k, v, dout = _k10_inputs(N, d, N + d)
    scale = d ** -0.5
    want = _vjp_jax(lambda *a: jax_flash_plain(*a, scale, interpret=True), (q, k, v), dout)
    got = _vjp_port(lambda *a: flash_attention.full_attention(*a, scale), (q, k, v), dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= 1e-5, (name, _rel_l2(g, w))


def test_k10_autograd_function_backward(monkeypatch):
    """The kernel path's autograd Function: the forward as launched (here its
    plain version), the backward the plain version's VJP, recomputed."""
    monkeypatch.setattr(flash_attention, "full_attention_cuda", flash_attention.full_attention_plain)
    q, k, v, dout = _k10_inputs(70, 16, 3)
    scale = 0.25
    got = _vjp_port(lambda *a: flash_attention._FullAttention.apply(*a, scale), (q, k, v), dout)
    want = _vjp_port(lambda *a: flash_attention.full_attention_plain(*a, scale), (q, k, v), dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def _k11_inputs(lead, C, M, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, C)).astype(np.float32)
    w1 = (rng.normal(size=(M, C)) * C ** -0.5).astype(np.float32)   # nn.Linear layout
    b1 = (0.1 * rng.normal(size=M)).astype(np.float32)
    w2 = (rng.normal(size=(C, M)) * M ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C)).astype(np.float32)
    dout = rng.normal(size=(*lead, C)).astype(np.float32)
    return (x, w1, b1, w2, b2), dout


@pytest.mark.parametrize("lead", [(2, 37), (5, 3, 7)])
def test_k11_plain_matches_jax(lead):
    """K11's plain version against ``fused_mlp(dtype=float32)``: the Pallas
    kernel in interpret mode, T = 74 or 105 tokens in leading dims (not a
    multiple of its token tile: the pad path); forward and VJP at 2e-6 (the
    Pallas body's Abramowitz-Stegun erf is within 1.5e-7 of erf)."""
    (x, w1, b1, w2, b2), dout = _k11_inputs(lead, 32, 256, len(lead))

    def jax_fn(x, w1, b1, w2, b2):  # flax layout: kernels (in, out)
        return jax_fused_mlp(x, w1.T, b1, w2.T, b2, dtype=jnp.float32, interpret=True)

    want = _vjp_jax(jax_fn, (x, w1, b1, w2, b2), dout)
    got = _vjp_port(fused_mlp.fused_mlp, (x, w1, b1, w2, b2), dout)
    for name, g, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= 2e-6, (name, _rel_l2(g, w))


def test_k11_autograd_function_backward(monkeypatch):
    """The kernel path's autograd Function on (T, C): the hidden layer
    recomputed, dW2 / db2 / dA by hand, the rest through autograd."""
    monkeypatch.setattr(fused_mlp, "fused_mlp_cuda", fused_mlp.fused_mlp_plain)
    args, dout = _k11_inputs((45,), 16, 128, 9)
    got = _vjp_port(fused_mlp._FusedMLP.apply, args, dout)
    want = _vjp_port(fused_mlp.fused_mlp_plain, args, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_k10_k11_cuda_paths_refuse_cpu_tensors():
    t = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.full_attention_cuda(t, t, t, 0.125)
    x, w1, w2 = torch.zeros(4, 768), torch.zeros(3072, 768), torch.zeros(768, 3072)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.fused_mlp_cuda(x, w1, torch.zeros(3072), w2, torch.zeros(768))


# ------------------------------------------------------- RVSA, UperNet ----


def _jax_apply(module, variables, *args, **kw):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args))


@pytest.mark.parametrize("hw", [(14, 14), (5, 5)])
def test_rvsa_attention_matches_jax(hw):
    """One RVSA attention on a 14x14 map (two windows a side) and on a 5x5
    map, padded symmetrically to one window."""
    jm = JaxRVSA(dim=32, num_heads=2, window_size=7)
    x = np.random.default_rng(3).normal(size=(2, *hw, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jvars = draw_variables(shapes, 4)
    want = _jax_apply(jm, jvars, jnp.asarray(x))
    model = RotatedVariedSizeWindowAttention(32, 2, 7)
    sd = {k.removeprefix("encoder.blocks.0.attn."): v for k, v in jax_params_to_torch(
        {"encoder": {"blocks_0": {"attn": jvars["params"]}}}).items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= TOL


@pytest.mark.parametrize("use_rel_pos", [False, True])
def test_full_attention_matches_jax(use_rel_pos):
    """The full-attention blocks, without rel-pos (RVSA's) and with it."""
    jm = JaxFullAttention(dim=32, num_heads=2, input_size=(6, 5), use_rel_pos=use_rel_pos)
    x = np.random.default_rng(8).normal(size=(2, 6, 5, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jvars = draw_variables(shapes, 9)
    want = _jax_apply(jm, jvars, jnp.asarray(x))
    model = FullAttentionRelPos(32, 2, input_size=(6, 5), use_rel_pos=use_rel_pos)
    sd = {k.removeprefix("encoder.blocks.0.attn."): v for k, v in jax_params_to_torch(
        {"encoder": {"blocks_0": {"attn": jvars["params"]}}}).items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) <= TOL


@pytest.fixture(scope="module")
def tiny_rvsa():
    """(flax module, variables, port module) of a width-32 RVSA trunk with
    two RVSA blocks and one full block."""
    jm = JaxViTRVSA(img_size=224, **TINY_RVSA)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    jvars = draw_variables(shapes, 6)
    model = ViTRVSA(img_size=224, **TINY_RVSA).eval()
    sd = {k.removeprefix("encoder."): v
          for k, v in jax_params_to_torch({"encoder": jvars["params"]}).items()}
    model.load_state_dict(sd, strict=True)
    return jm, jvars, model


@pytest.mark.parametrize("size", [224, 80])
def test_vit_rvsa_matches_jax(tiny_rvsa, size):
    """The trunk and neck on 14x14 and on 5x5 token maps."""
    jm, jvars, model = tiny_rvsa
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a))(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        g = g.permute(0, 2, 3, 1).numpy()  # the port's maps are NCHW
        assert g.shape == w.shape, i
        assert _rel_l2(g, w) <= TOL, (i, _rel_l2(g, w))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_vit_rvsa_k10_k11_routing_matches_jax_flash_fused(tiny_rvsa, use_kernels):
    """The trunk with its full block through K10 and its MLPs through K11
    (the plain versions here) against flax with the process defaults set to
    "flash" / "fused"; and the port's plain routing against the same."""
    jm, jvars, model = tiny_rvsa
    x = np.random.default_rng(31).normal(size=(2, 224, 224, 3)).astype(np.float32)
    try:
        jax_layers.set_default_attn_impl("flash")
        jax_layers.set_default_mlp_impl("fused")
        want = jax.jit(lambda v, a: jm.apply(v, a))(jvars, jnp.asarray(x))
    finally:
        jax_layers.set_default_attn_impl("xla")
        jax_layers.set_default_mlp_impl("xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), use_kernels=use_kernels)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert _rel_l2(g.permute(0, 2, 3, 1).numpy(), w) <= TOL, i


def test_rvsa_bridge_round_trip(tiny_rvsa):
    """The JAX package's reference-checkpoint loader reads the port's
    encoder state dict back into the flax tree exactly."""
    _, jvars, model = tiny_rvsa
    params = jax.tree_util.tree_map(np.zeros_like, jvars["params"])
    loaded, _, skipped = load_torch_rvsa_backbone(model.state_dict(), params)
    assert skipped == []  # nothing the loader would not always skip
    flat_want = flax.traverse_util.flatten_dict(jvars["params"])
    flat_got = flax.traverse_util.flatten_dict(loaded)
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg="/".join(k))


@pytest.mark.parametrize("train", [False, True])
def test_upernet_matches_jax(train):
    """UperNet on c1..c4 of a 5x5-token backbone (20, 10, 5, 2 pixels a
    side); in training also the BatchNorm running statistics (flax momentum
    0.9, biased variance)."""
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(2, 80, 80, 3)).astype(np.float32)] + [
        rng.normal(size=(2, s, s, 16)).astype(np.float32) for s in (20, 10, 5, 2)]
    jm = JaxUPerHead(channels=16)
    jf = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jf))
    jvars = draw_variables(shapes, 12)
    out = jax.jit(lambda v, f: jm.apply(v, f, train, mutable=["batch_stats"]))(jvars, jf)
    want, new_stats = out
    model = UPerHead([16] * 4, channels=16).train(train)
    sd = {k.removeprefix("seg_decoder."): v for k, v in jax_params_to_torch(
        {"seg_decoder": jvars["params"]}, {"seg_decoder": jvars["batch_stats"]}).items()}
    model.load_state_dict(sd, strict=True)
    tf = [torch.from_numpy(feats[0])] + [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats[1:]]
    with torch.no_grad():
        got = model(tf).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 80, 80, 16)
    assert _rel_l2(got, want) <= TOL
    stats = {k.removeprefix("seg_decoder."): v for k, v in jax_params_to_torch(
        {}, {"seg_decoder": new_stats["batch_stats"]}).items()}
    for k, v in stats.items():
        assert _rel_l2(model.state_dict()[k].numpy(), v.numpy()) <= TOL, k
