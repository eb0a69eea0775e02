"""ViT-Adapter-B in the PyTorch port (samrs_tpu_torch.seg.backbones.vit_adapter)
vs the JAX package, on CPU in fp32.

Each module runs on flax variables whose every leaf is drawn with numpy
(draw_variables: the sampling nets and the injector gammas too, so the
sampling coordinates are generic), bridged with ``jax_params_to_torch`` and
loaded strictly, on the same seeded inputs: the outputs, the gradients of a
fixed random projection of them with respect to every parameter, and the
BatchNorm statistics after the forward, in train mode.  The JAX MSDeformAttn
takes its XLA gather off the TPU; the port its plain version (K8's, on the
CPU).  ``ms_deform_attn_hybrid`` is held against JAX's with the Pallas
kernels in interpret mode.  Also: the bridge against the reference key layout
(JAX's ``.pth`` loader reads the port's state dict), the published model's
parameters, ``SAMRS_MSDA_IMPL``, per-block checkpointing.  The optimizer row,
one SEP step and ``run_pretrain`` are in test_torch_port_vit_adapter_train.py.
"""


import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from samrs_tpu.kernels import bilinear_gather as jax_bg
from samrs_tpu.seg.backbones import vit_adapter as jax_va
from samrs_tpu.seg.port import load_torch_vit_adapter_backbone
from samrs_tpu_torch.kernels import bilinear_gather
from samrs_tpu_torch.nn.layers import resize_bilinear
from samrs_tpu_torch.seg.backbones import vit_adapter
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from test_torch_port_seg import _rel_l2, draw_variables

TOL = 1e-4  # fp32 both sides; only summation order differs
SIZE = 64   # patch grid 4x4; c1..c4 16^2 .. 2^2
INTERACTIONS = {4: ((0, 0), (1, 1), (2, 2), (3, 3)), 2: ((0, 1), (2, 3))}
TINY = dict(img_size=SIZE, patch_size=16, embed_dim=32, depth=4, num_heads=2,
            deform_num_heads=2, drop_path_rate=0.0)
SHAPES_C = [(8, 8), (4, 4), (2, 2)]
# per-channel shifts that a BatchNorm removes next (norm1 after f1 = fc1(c1) + up(f2) + ...):
# no true gradient, so both sides return rounding noise there; held to noise apart
NO_GRAD = ("up.bias", "spm.fc1.bias")


def _nested(path, tree):
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _port_names(tree, path, prefix, stats=False):
    """A flax-layout tree under `path` in the port's names, `prefix` stripped."""
    sd = jax_params_to_torch({}, _nested(path, tree)) if stats else \
        jax_params_to_torch(_nested(path, tree))
    return {k.removeprefix(prefix): v for k, v in sd.items()}


def _parity(jm, jargs, pm, pcall, path, prefix, seed, jout=lambda o: [o], train=True,
            side=0.0, no_grad=NO_GRAD):
    """Draw jm's variables, load them into pm, run both on the same inputs
    and return {"out": [rel-L2 per output], "grad": {name: rel-L2},
    "noise": {name: largest |gradient| of either side / the gradient's norm}
    for the `no_grad` parameters, "stats": {name: rel-L2}}: the gradients are
    those of sum(out_i * r_i) with fixed numpy draws r_i (the port's layout),
    the statistics the BatchNorm running averages after the forward.
    ``pcall(pm, s)`` runs the port on its inputs scaled by 1 + s, s =
    `side` for the outputs, the gradients and the statistics alike (see
    KINK_SIDE)."""
    variables = draw_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs)),
                               seed)
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = _port_names(params, path, prefix)
    sd.update(_port_names(stats, path, prefix, stats=True) if stats else {})
    pm.load_state_dict(sd, strict=True)
    pm.zero_grad(set_to_none=True)
    pm.train(train)
    pouts = pcall(pm, side)
    rng = np.random.default_rng(seed + 1)
    rs = [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in pouts]
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(pouts, rs)).backward()
    got_g = {n: p.grad for n, p in pm.named_parameters()}
    psd = {k: v.clone() for k, v in pm.state_dict().items()}

    def loss(p):
        outs, upd = jm.apply({"params": p, "batch_stats": stats}, *jargs, mutable=["batch_stats"])
        outs = jout(outs)
        return sum((o * r).sum() for o, r in zip(outs, rs)), (outs, upd)

    (_, (jouts, upd)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    assert len(jouts) == len(pouts)
    want_g = _port_names(jgrads, path, prefix)
    assert set(want_g) == set(got_g)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in want_g.values()))
    return {"out": [_rel_l2(o.detach().numpy(), np.asarray(w)) for o, w in zip(pouts, jouts)],
            "grad": {n: _rel(got_g[n].numpy(), w.numpy())
                     for n, w in want_g.items() if n not in no_grad},
            "noise": {n: max(float(g.abs().max()) for g in (got_g[n], want_g[n])) / total
                      for n in no_grad if n in want_g},
            "stats": {n: _rel(psd[n].numpy(), w.numpy()) for n, w in
                      _port_names(upd.get("batch_stats", {}), path, prefix, stats=True).items()}}


def _rel(got, want):
    """Relative L2 distance; 0 when both are zero (a ReLU that is off for
    every input gives its parameters no gradient), inf when only `want` is."""
    if not want.any():
        return 0.0 if not got.any() else float("inf")
    return _rel_l2(got, want)


def _assert_parity(res, n_stats=0):
    assert not any(np.isnan(v) for v in [*res["out"], *res["grad"].values(),
                                          *res["stats"].values()])
    assert max(res["out"]) <= TOL, res["out"]
    worst = max(res["grad"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL, worst
    assert len(res["stats"]) == n_stats
    if n_stats:
        worst = max(res["stats"].items(), key=lambda kv: kv[1])
        assert worst[1] <= TOL, worst


def _nchw(outs):
    return [jnp.transpose(o, (0, 3, 1, 2)) for o in outs]


# ---------------------------------------------------------- modules ----


@pytest.mark.parametrize("train", [True, False])
def test_spatial_prior_module_matches_flax(train):
    """The stem, conv2..conv4 and the four 1x1 projections; in train mode the
    batch statistics and the six BatchNorms' running averages (momentum 0.9,
    the biased batch variance), in eval mode the running statistics (left
    as they were)."""
    x = np.random.default_rng(1).normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    res = _parity(jax_va.SpatialPriorModule(64, 32), (jnp.asarray(x), train),
                  vit_adapter.SpatialPriorModule(64, 32),
                  lambda m, _: list(m(torch.from_numpy(x).permute(0, 3, 1, 2))),
                  ["encoder", "spm"], "encoder.spm.", 2, jout=_nchw, train=train)
    _assert_parity(res, n_stats=12)


def _tokens(seed, shapes, B=2, D=32):
    return np.random.default_rng(seed).normal(size=(B, sum(h * w for h, w in shapes), D)) \
        .astype(np.float32)


def test_conv_ffn_matches_flax():
    """fc1, one depthwise conv shared by the three levels, exact GELU, fc2."""
    x = _tokens(3, SHAPES_C)
    res = _parity(jax_va.ConvFFN(8, SHAPES_C), (jnp.asarray(x),), vit_adapter.ConvFFN(32, 8),
                  lambda m, _: [m(torch.from_numpy(x), SHAPES_C)],
                  ["encoder", "extractor0", "ffn"], "encoder.interactions.0.extractor.ffn.", 4)
    _assert_parity(res)


def test_extractor_matches_flax():
    """query / feat / ffn LayerNorms, a one-level MSDeformAttn from the ViT
    tokens (4x4) into the conv tokens (8^2 + 4^2 + 2^2), ConvFFN."""
    c, t = _tokens(5, SHAPES_C), _tokens(6, [(4, 4)])
    ref_c = np.asarray(jnp.broadcast_to(jax_va._ref_points(SHAPES_C), (2, c.shape[1], 2)))[
        :, :, None, :]
    jm = jax_va.Extractor(32, 2, 4, 0.5, 0.25, SHAPES_C)
    pm = vit_adapter.Extractor(32, 2, 4, 0.5, 0.25)
    res = _parity(jm, (jnp.asarray(c), jnp.asarray(ref_c), jnp.asarray(t), [(4, 4)]), pm,
                  lambda m, _: [m(*(torch.from_numpy(a) for a in (c, ref_c, t)), [(4, 4)],
                                  SHAPES_C)],
                  ["encoder", "extractor0"], "encoder.interactions.0.extractor.", 7)
    _assert_parity(res)


# the input scaling of the 4-interaction model's port run: there one BatchNorm output of
# the spatial prior (conv2's, before its ReLU) lies 1.5e-7 from 0, and the two fp32 paths
# put it on opposite sides of the ReLU's kink at the same input; at 1 + 1e-7 the port's
# rounding falls on JAX's side (at 1: 6e-3 apart in the spatial prior's parameters, 1e-5
# elsewhere).  Outputs, every gradient and the statistics are all taken at that one input.
KINK_SIDE = 1e-7


@pytest.fixture(scope="module", params=[4, 2], ids=["4_interactions", "2_interactions"])
def adapter_run(request):
    n = request.param
    cfg = dict(TINY, interaction_indexes=INTERACTIONS[n])
    x = np.random.default_rng(8).normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    res = _parity(jax_va.ViTAdapter(**cfg), (jnp.asarray(x), True), vit_adapter.ViTAdapter(**cfg),
                  lambda m, s: m(torch.from_numpy(x * np.float32(1 + s)))[1:], ["encoder"],
                  "encoder.", 10 + n, jout=lambda outs: _nchw(outs[1:]),
                  side=KINK_SIDE if n == 4 else 0.0)
    return n, res


def test_vit_adapter_features_match_flax(adapter_run):
    """f1..f4 of a tiny ViT-Adapter (4 blocks 32 wide): with 4 interactions
    each interaction's ViT map feeds its own scale, with 2 the final map
    feeds every scale (x4 / x2 bilinear up, as is, the 0.5x downscale of
    ``jax.image.resize(antialias=False)``)."""
    _, res = adapter_run
    assert len(res["out"]) == 4
    assert max(res["out"]) <= TOL, res["out"]


def test_vit_adapter_gradients_match_flax(adapter_run):
    """Every parameter's gradient: the spatial prior, level_embed, the
    injectors (gammas, sampling nets, value / output projections), the
    blocks and their layer scales, the extractors and the extra extractors,
    up, the final norms; each within TOL of JAX's (with 4 interactions, the
    port's input scaled by 1 + KINK_SIDE)."""
    n, res = adapter_run
    worst = max(res["grad"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL, worst
    assert set(res["noise"]) == set(NO_GRAD)
    assert max(res["noise"].values()) <= 1e-6, res["noise"]
    assert f"interactions.{n - 1}.extra_extractors.1.ffn.dwconv.dwconv.weight" in res["grad"]
    assert "blocks.3.gamma2" in res["grad"] and "up.weight" in res["grad"]


def test_vit_adapter_batch_stats_match_flax(adapter_run):
    """The spatial prior's six BatchNorms and norm1..norm4 after one
    train-mode forward."""
    _, res = adapter_run
    assert len(res["stats"]) == 20
    worst = max(res["stats"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL, worst


@pytest.mark.parametrize("hw,out", [((14, 14), (7, 7)), ((14, 14), (28, 28)),
                                    ((14, 14), (56, 56)), ((5, 7), (3, 4))])
def test_add_vit_feature_resize_matches_jax_without_antialias(hw, out):
    """The adapter's ``resize_bilinear`` (torch's bilinear) is the JAX
    module's ``jax.image.resize(..., "bilinear", antialias=False)``: the x4
    and x2 upscales into c1 / c2 and the 0.5x downscale into c4."""
    x = np.random.default_rng(hw[1]).normal(size=(2, *hw, 6)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 6), "bilinear", antialias=False)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- MSDA hybrid ----


def _msda_inputs(seed, B=2, nH=2, D=8, Q=7, P=3, levels=((8, 8), (4, 4), (2, 2))):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, S, nH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, nH, len(levels), P, 2)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (B, Q, nH, len(levels), P)).astype(np.float32)
    return list(levels), value, loc, w / w.sum((-1, -2), keepdims=True)


@pytest.mark.parametrize("big_impl", ["xla", "ghb"])
def test_ms_deform_attn_hybrid_matches_jax_interpret(big_impl):
    """The per-level split at min_rows_xla 4 (the 8^2 and 4^2 levels take the
    big route, 2^2 the small one) against JAX's with the Pallas kernels in
    interpret mode, forward and gradients of value, locations and weights;
    and against the port's ``ms_deform_attn`` of all levels at once."""
    levels, value, loc, w = _msda_inputs(11)
    g = np.random.default_rng(12).normal(size=(2, 7, 16)).astype(np.float32)

    def jf(v, l, a):
        out = jax_bg.ms_deform_attn_hybrid(v, levels, l, a, min_rows_xla=4, interpret=True,
                                           big_impl=big_impl)
        return (out * g).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (value, loc, w)))
    results = {}
    for name, fn in (("hybrid", lambda *a: bilinear_gather.ms_deform_attn_hybrid(
            *a[:1], levels, *a[1:], min_rows_xla=4, big_impl=big_impl)),
                     ("dense", lambda *a: bilinear_gather.ms_deform_attn(a[0], levels, *a[1:]))):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w)]
        out = fn(*leaves)
        (out * torch.from_numpy(g)).sum().backward()
        results[name] = [out.detach()] + [t.grad for t in leaves]
    for got in results.values():
        for a, b in zip(got, [jout, *jgrads]):
            assert _rel_l2(a.numpy(), np.asarray(b)) <= 1e-5
    for a, b in zip(results["hybrid"], results["dense"]):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-6


@pytest.mark.parametrize("impl,route", [(None, "dense"), ("pallas", "dense"), ("xla", "plain"),
                                        ("hybrid", "hybrid"), ("hybrid:4:ghb", "hybrid")])
def test_msda_module_reads_samrs_msda_impl(monkeypatch, impl, route):
    """``SAMRS_MSDA_IMPL`` routes the module's sampling as the JAX module does
    (``pallas``, the default: K8; ``xla``: the plain version; ``hybrid[:rows
    [:big]]``: ``ms_deform_attn_hybrid`` with those arguments); every route
    gives the same values, and ``use_kernels=False`` is the plain version."""
    if impl is None:
        monkeypatch.delenv("SAMRS_MSDA_IMPL", raising=False)
    else:
        monkeypatch.setenv("SAMRS_MSDA_IMPL", impl)
    calls = []
    real_dense, real_hybrid = bilinear_gather.ms_deform_attn, bilinear_gather.ms_deform_attn_hybrid

    def dense(*a, plain=False, **kw):
        calls.append("plain" if plain else "dense")
        return real_dense(*a, plain=plain, **kw)

    def hybrid(*a, **kw):
        calls.append(("hybrid", kw))
        return real_hybrid(*a, **kw)

    monkeypatch.setattr(bilinear_gather, "ms_deform_attn", dense)
    monkeypatch.setattr(bilinear_gather, "ms_deform_attn_hybrid", hybrid)
    torch.manual_seed(0)
    m = vit_adapter.MSDeformAttnModule(16, 3, 2, 2, 0.5)
    nn.init.normal_(m.sampling_offsets.weight, std=0.1)
    q = torch.randn(2, 5, 16)
    ref = torch.rand(2, 5, 3, 2)
    val = torch.randn(2, 84, 16)
    out = m(q, ref, val, [(8, 8), (4, 4), (2, 2)])
    if route == "hybrid":
        want_kw = {"min_rows_xla": 4, "big_impl": "ghb"} if impl != "hybrid" else \
            {"min_rows_xla": 128, "big_impl": "xla"}
        assert calls[0] == ("hybrid", want_kw)
    else:
        assert calls == [route]
    calls.clear()
    plain = m(q, ref, val, [(8, 8), (4, 4), (2, 2)], use_kernels=False)
    assert calls == ["plain"]
    assert torch.allclose(out, plain, rtol=1e-6, atol=1e-6)


# ----------------------------------------------- layout and settings ----


def test_state_dict_is_the_reference_layout():
    """JAX's ``.pth`` loader for the reference ViT-Adapter
    (``load_torch_vit_adapter_backbone``) reads the port's state dict key by
    key, nothing skipped, and returns the flax variables it came from."""
    cfg = dict(TINY, interaction_indexes=INTERACTIONS[4])
    jm = jax_va.ViTAdapter(**cfg)
    variables = draw_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))), 14)
    pm = vit_adapter.ViTAdapter(**cfg)
    sd = _port_names(variables["params"], ["encoder"], "encoder.")
    sd.update(_port_names(variables["batch_stats"], ["encoder"], "encoder.", stats=True))
    pm.load_state_dict(sd, strict=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats, loaded, skipped = load_torch_vit_adapter_backbone(
        pm.state_dict(), zeros["params"], zeros["batch_stats"])
    assert not skipped
    assert len(loaded) == len(pm.state_dict())
    for tree, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = (flax.traverse_util.flatten_dict(t) for t in (tree, want))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))


def test_published_vit_adapter_b_layout_and_size():
    """``get_backbone("vit_adapter_b")``: the published widths (ViT-B, 12
    deformable heads, 4 points, deform ratio 0.5, cffn ratio 0.25, drop path
    0.3, 4 interactions of 3 blocks, 2 extra extractors); the bridge of the
    flax model's full-size variables gives exactly the port's keys and
    shapes, so the parameter counts agree."""
    shapes = jax.eval_shape(lambda: jax_va.vit_adapter_b().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k.removeprefix("encoder."): tuple(v.shape) for k, v in jax_params_to_torch(
        {"encoder": zeros["params"]}, {"encoder": zeros["batch_stats"]}).items()}
    with torch.device("meta"):
        pm = get_backbone("vit_adapter_b")
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    assert pm.out_channels == jax_va.vit_adapter_b().out_channels == (3, 768, 768, 768, 768)
    assert pm.interactions[3].extra_extractors is not None
    assert pm.blocks[11].drop_path.rate == pytest.approx(0.3)


def test_per_block_checkpointing_gives_the_same_gradients():
    """``use_checkpoint`` (``remat=True`` in the frameworks) recomputes each
    ViT block in the backward: the same loss and gradients, and the
    BatchNorm statistics updated once."""
    cfg = dict(TINY, interaction_indexes=INTERACTIONS[2])
    runs = []
    for ckpt in (False, True):
        torch.manual_seed(3)
        m = vit_adapter.ViTAdapter(**cfg, use_checkpoint=ckpt).train()
        x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(4))
        sum(f.square().mean() for f in m(x)[1:]).backward()
        runs.append((m.state_dict(), {n: p.grad for n, p in m.named_parameters()}))
    (s0, g0), (s1, g1) = runs
    for k in s0:
        assert torch.allclose(s0[k], s1[k], rtol=1e-6, atol=1e-7), k
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-5, atol=1e-7), k
