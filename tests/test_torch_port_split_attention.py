"""K12 (split-head rel-pos attention) and K4 (the decoder's K/V projection)
of the port, on the CPU.

K12's plain version is held in fp32 against the JAX oracle
``window_attention_xla`` and the two Pallas kernels it replaces, run in
interpret mode (``_window_attention_pallas``, ``_flash_attention_fwd_pallas``),
at atol = rtol = 1e-4 (both sides fp32: only the summation order differs),
and in bf16 against an explicit run of the softmax of the kernel's form (one
softmax over a window, or 128-key tiles) at 1e-5.  The rel rows the kernels
make on the card are modelled (an fp32 dot product over d in increasing
order) and held against ``rel_rows`` and the JAX package's einsum; the
kernels' thread mappings (K1's and K2's rel-row kernels, the window form's
persistent schedule, K4's 32-row blocks) are modelled to show that every
output is written once.  The wrappers are held to their refusals with the
build faked: nothing is built, nothing is counted.  The CUDA kernels
themselves run only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from samrs_tpu.kernels.flash_attention import _flash_attention_fwd_pallas
from samrs_tpu.kernels.window_attention import _window_attention_pallas, window_attention_xla
from samrs_tpu_torch.kernels import (_build, flash_attention, fused_twoway, fused_window_layer,
                                     window_attention as wa)

TOL = 1e-4  # fp32 on both sides; only summation order differs
SMS = 132  # the H100's SMs: the window form's grid is min(units, SMs)
QUERY_TILE = 64  # query rows of a window-form work unit (csrc/window_attention.cu)

# (kh, kw) grids: a 7 x 7 and a 14 x 14 window (the window form), a 16 x 16
# global grid (256 tokens, a multiple of the Pallas flash kernel's 128-row
# query tile; the query-tiled form)
GRIDS = {"7x7": (7, 7), "14x14": (14, 14), "16x16": (16, 16)}


def _inputs(rng, B, kh, kw, d, bf16_values=False):
    N = kh * kw
    f = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    q, k, v = f(B, N, d), f(B, N, d), f(B, N, d)
    if bf16_values:  # values a bf16 tensor holds, kept in fp32
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    return q, k, v, f(kh, kh, d, std=0.3), f(kw, kw, d, std=0.3)


def _jax_rel_rows(q, Rh, Rw, hw):
    kh, kw = hw
    B, N, d = q.shape
    jq = jnp.asarray(q).reshape(B, kh, kw, d)
    rel_h = jnp.einsum("bhwc,hkc->bhwk", jq, jnp.asarray(Rh)).reshape(B, N, kh)
    rel_w = jnp.einsum("bhwc,wkc->bhwk", jq, jnp.asarray(Rw)).reshape(B, N, kw)
    return rel_h, rel_w


# the Pallas flash kernel takes N % 128 == 0: the 16 x 16 grid only
ORACLE_GRIDS = ([("xla", g) for g in sorted(GRIDS)] + [("pallas_window", g) for g in sorted(GRIDS)]
                + [("pallas_flash", "16x16")])


@pytest.mark.parametrize("oracle,grid", ORACLE_GRIDS)
@pytest.mark.parametrize("d", [64, 80])
def test_split_plain_matches_jax(oracle, d, grid):
    """K12's plain version (the rounding of the form ``split_form`` picks)
    against the JAX oracle and the Pallas kernels in interpret mode, fp32."""
    kh, kw = GRIDS[grid]
    N = kh * kw
    rng = np.random.default_rng(7 + d + N)
    q, k, v, Rh, Rw = _inputs(rng, 2, kh, kw, d)
    rel_h, rel_w = _jax_rel_rows(q, Rh, Rw, (kh, kw))
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [rel_h, rel_w, d ** -0.5]
    want = {"xla": lambda: window_attention_xla(*jargs),
            "pallas_window": lambda: _window_attention_pallas(*jargs, interpret=True),
            "pallas_flash": lambda: _flash_attention_fwd_pallas(*jargs, interpret=True)}[oracle]()
    t = torch.from_numpy
    got = wa.window_attention_relpos(t(q), t(k), t(v), t(Rh), t(Rw), (kh, kw), d ** -0.5)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, N, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    got_plain = wa.split_attention_plain(t(q), t(k), t(v), t(np.array(rel_h)),
                                         t(np.array(rel_w)), d ** -0.5)
    np.testing.assert_allclose(got_plain.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_forms_follow_the_grid():
    """The window form takes N <= 196 with kh + kw <= 32 (the windows, small
    global grids); every other grid, the 16 x 16 one among them, is tiled."""
    assert wa.split_form(196, 14, 14) == "window"
    assert wa.split_form(49, 7, 7) == "window"
    assert wa.split_form(36, 6, 6) == "window"
    assert wa.split_form(196, 7, 28) == "tiled"  # 35 rel terms a token
    for g in (16, 32, 48, 64):
        assert wa.split_form(g * g, g, g) == "tiled"
    assert wa.key_tile(196, 14, 14) == flash_attention.K1_KEY_TILE >= 196
    assert wa.key_tile(256, 16, 16) == flash_attention.K2_KEY_TILE


def _softmax_loop(s, v, tile):
    """An explicit key-tile by key-tile online softmax, P rounded to bf16
    (running max, row sums of the rounded values, rescaled)."""
    n = s.shape[-1]
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    den, o = torch.zeros(s.shape[:-1] + (1,)), torch.zeros(s.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, n, tile):
        blk = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        p = torch.exp(blk - m_new).bfloat16().float()
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p @ v[..., k0:k0 + tile, :].float()
        m = m_new
    return o / den


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_plain_rounds_as_its_form(grid):
    """In bf16 the plain version rounds its probabilities as the kernel's
    form does: one softmax over a window's keys, or 128-key tiles."""
    kh, kw = GRIDS[grid]
    rng = np.random.default_rng(21 + kh)
    q, k, v, _, _ = (torch.from_numpy(a) for a in _inputs(rng, 2, kh, kw, 64))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    rel_h = torch.from_numpy(rng.normal(size=(2, kh * kw, kh)).astype(np.float32))
    rel_w = torch.from_numpy(rng.normal(size=(2, kh * kw, kw)).astype(np.float32))
    s = wa._logits(q, k, rel_h, rel_w, 64 ** -0.5)
    tile = 128 if wa.split_form(kh * kw, kh, kw) == "tiled" else kh * kw
    want = _softmax_loop(s, v, tile)
    got = wa.split_attention_plain(q, k, v, rel_h, rel_w, 64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _fma_dot_model(q, T):
    """The rel-row kernels' arithmetic: an fp32 multiply-add chain over d in
    increasing order, from 0 (products exact in fp64, one rounding a step).
    q (..., d), T (..., d) -> (...)."""
    acc = np.zeros(np.broadcast_shapes(q.shape[:-1], T.shape[:-1]), np.float32)
    for i in range(q.shape[-1]):
        acc = (q[..., i].astype(np.float64) * T[..., i] + acc).astype(np.float32)
    return acc


def _rel_rows_model(q, Rh, Rw, hw):
    kh, kw = hw
    B, N, d = q.shape
    gq = q.reshape(B, kh, kw, 1, d)
    rel_h = _fma_dot_model(gq, Rh[None, :, None, :, :]).reshape(B, N, kh)
    rel_w = _fma_dot_model(gq, Rw[None, None, :, :, :]).reshape(B, N, kw)
    return rel_h, rel_w


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("d", [64, 80])
def test_rel_row_model_matches_rel_rows_and_jax(d, grid):
    """The modelled rel-row kernel (bf16 q read in place, fp32 dot products
    in increasing d) against the plain ``rel_rows`` and the JAX einsum on the
    same values."""
    kh, kw = GRIDS[grid]
    rng = np.random.default_rng(40 + d + kh)
    q, _, _, Rh, Rw = _inputs(rng, 3, kh, kw, d, bf16_values=True)
    model = _rel_rows_model(q, Rh, Rw, (kh, kw))
    plain = wa.rel_rows(torch.from_numpy(q).bfloat16(), torch.from_numpy(Rh),
                        torch.from_numpy(Rw), (kh, kw))
    jax_rows = _jax_rel_rows(q, Rh, Rw, (kh, kw))
    for m, p, j in zip(model, plain, jax_rows):
        np.testing.assert_allclose(m, p.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m, np.asarray(j), rtol=1e-5, atol=1e-5)


def test_window_rel_kernel_mapping_writes_each_term_once():
    """K1's rel kernel on split heads: 112 threads a window, thread (T, a,
    qb, ub) computes the 7 x 7 block of tokens sharing table row a (T 0: grid
    row, T 1: grid column) times table rows 7 ub + k; the terms land in the
    rel_h plane (T 0) and the rel_w plane (T 1), each (token, u) once."""
    WIN, NT = 14, 196
    planes = np.zeros((2, NT, WIN), int)
    for lt in range(112):
        T, r = lt // 56, lt % 56
        a, qb, ub = r // 4, (r >> 1) & 1, r & 1
        for i in range(7):
            tok = a * WIN + qb * 7 + i if T == 0 else (qb * 7 + i) * WIN + a
            # the token's grid row (T 0) or column (T 1) is a: the table it reads
            assert (tok // WIN if T == 0 else tok % WIN) == a
            for k in range(7):
                planes[T, tok, ub * 7 + k] += 1
    assert (planes == 1).all()


@pytest.mark.parametrize("grid", [(7, 7), (16, 16), (32, 32), (64, 64), (14, 14), (4, 50)])
def test_relpos_rows_kernel_mapping_writes_each_term_once(grid):
    """K2's rel-row kernel on split heads: block x < kh takes grid row x
    against Th[x], block kh + y grid column y against Tw[y]; 64-query by
    64-row tiles, thread (tq, tk) the outputs tq + 16 i, tk + 16 j; each
    (token, term) of rel_h and rel_w once."""
    kh, kw = grid
    rel_h, rel_w = np.zeros((kh * kw, kh), int), np.zeros((kh * kw, kw), int)
    for bx in range(kh + kw):
        row = bx < kh
        sel = bx if row else bx - kh
        nq, K = (kw, kh) if row else (kh, kw)
        out = rel_h if row else rel_w
        for q0 in range(0, nq, 64):
            for k0 in range(0, K, 64):
                for tid in range(256):
                    tq, tk = tid >> 4, tid & 15
                    for i in range(4):
                        qq = q0 + tq + 16 * i
                        if qq >= nq:
                            continue
                        n = sel * kw + qq if row else qq * kw + sel
                        for j in range(4):
                            kk = k0 + tk + 16 * j
                            if kk < K:
                                out[n, kk] += 1
    assert (rel_h == 1).all() and (rel_w == 1).all()


def _window_schedule(items, qtiles, sms=SMS):
    """The window form's persistent schedule (csrc/window_attention.cu):
    units = items x qtiles, grid min(units, SMs), block x takes the units
    [units x / grid, units (x + 1) / grid), its two consumer warpgroups every
    other one.  Returns {block: [(item, tile, warpgroup)]}."""
    units = items * qtiles
    grid = min(units, sms)
    out = {}
    for x in range(grid):
        u0, u1 = units * x // grid, units * (x + 1) // grid
        out[x] = [(u // qtiles, u % qtiles, (u - u0) & 1) for u in range(u0, u1)]
    return out


@pytest.mark.parametrize("B,N", [(400, 196), (16 * 25, 196), (3, 196), (16, 49), (16, 36),
                                 (1, 196), (1000, 64)])
def test_window_schedule_takes_every_tile_once(B, N):
    """Every (row of B', 64-query tile) is taken once; the last wave is at
    most one tile longer than the others; each block's two warpgroups split
    its range within one tile."""
    qtiles = -(-N // QUERY_TILE)
    sched = _window_schedule(B, qtiles)
    taken = [(i, t) for units in sched.values() for i, t, _ in units]
    assert sorted(taken) == [(i, t) for i in range(B) for t in range(qtiles)]
    sizes = [len(units) for units in sched.values()]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    for units in sched.values():
        per_wg = [sum(1 for *_, c in units if c == w) for w in (0, 1)]
        assert abs(per_wg[0] - per_wg[1]) <= 1
    # the rows a tile holds: 64, the last one N - 64 (qtiles - 1)
    assert N - QUERY_TILE * (qtiles - 1) in range(1, QUERY_TILE + 1)


def _fake_build(monkeypatch, calls):
    """No CUDA: tensors pass as if on the card, launches are recorded, and a
    build fails the test."""
    def no_build():
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(wa, "launches", 0)
    monkeypatch.setattr(fused_twoway, "kv_launches", 0)
    monkeypatch.setattr(fused_window_layer, "_fp32_table", lambda t, device: t)


def _split_args(B, N, d, kh, kw, offset=0):
    """q, k, v views of one bf16 buffer (q starting `offset` elements in),
    fp32 rel rows."""
    buf = torch.zeros(3 * B * N * d + offset, dtype=torch.bfloat16)
    q, k, v = buf[offset:].view(3, B, N, d).unbind(0)
    return q, k, v, torch.zeros(B, N, kh), torch.zeros(B, N, kw)


@pytest.mark.parametrize("case", ["head48", "misaligned", "grid"])
def test_split_wrappers_refuse_before_building(monkeypatch, case):
    """A head other than 64 / 80, a base off 16 bytes, or kh * kw != N: the
    attention and the rel-row wrappers raise, build nothing, count nothing."""
    calls = []
    _fake_build(monkeypatch, calls)
    B, N, d, kh, kw, offset = {"head48": (2, 196, 48, 14, 14, 0),
                               "misaligned": (2, 196, 64, 14, 14, 1),
                               "grid": (2, 196, 64, 12, 16, 0)}[case]
    q, k, v, rel_h, rel_w = _split_args(B, N, d, kh, kw, offset)
    match = {"head48": "head_dim", "misaligned": "aligned", "grid": "grid"}[case]
    with pytest.raises(ValueError, match=match):
        wa.split_attention_cuda(q, k, v, rel_h, rel_w, d ** -0.5)
    with pytest.raises(ValueError, match=match):
        wa.rel_rows_cuda(q, torch.zeros(kh, kh, d), torch.zeros(kw, kw, d), (kh, kw))
    assert calls == [] and wa.launches == 0


def test_split_wrappers_launch_the_forms(monkeypatch):
    """Each form and rel-row kernel by its C entry, one count an attention
    call, none for the rel rows."""
    calls = []
    _fake_build(monkeypatch, calls)
    for (kh, kw), form, rel in (((14, 14), "window", "samrs_split_window_rel"),
                                ((6, 6), "window", "samrs_split_relpos_rows"),
                                ((16, 16), "tiled", "samrs_split_relpos_rows"),
                                ((64, 64), "tiled", "samrs_split_relpos_rows")):
        calls.clear()
        before = wa.launches
        q, k, v, _, _ = _split_args(2, kh * kw, 80, kh, kw)
        Rh, Rw = torch.zeros(kh, kh, 80), torch.zeros(kw, kw, 80)
        rel_h, rel_w = wa.rel_rows_cuda(q, Rh, Rw, (kh, kw))
        assert tuple(rel_h.shape) == (2, kh * kw, kh) and tuple(rel_w.shape) == (2, kh * kw, kw)
        out = wa.split_attention_cuda(q, k, v, rel_h, rel_w, 0.1)
        assert tuple(out.shape) == (2, kh * kw, 80) and out.dtype == torch.float32
        assert [c[0] for c in calls] == [rel, f"samrs_split_attention_{form}"]
        assert calls[1][1][6:] == (2, kh * kw, 80, kh, kw, 0.1)
        assert wa.launches == before + 1


def test_split_on_cpu_builds_nothing_and_counts_nothing(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(wa, "launches", 0)
    rng = np.random.default_rng(3)
    q, k, v, Rh, Rw = (torch.from_numpy(a) for a in _inputs(rng, 2, 14, 14, 64))
    out = wa.window_attention_relpos(q, k, v, Rh, Rw, (14, 14), 0.125)
    out2 = flash_attention.flash_attention_relpos(q, k, v, Rh, Rw, (14, 14), 0.125)
    assert torch.equal(out, out2) and wa.launches == 0


def _kv_block_writes(B, N):
    """K4's mapping (csrc/twoway.cu t2i_kv_kernel): grid (B, N / 32), 256
    threads; warpgroup w writes output w (K, V); warp wi < 2 of it rows
    wi 16 + g and + 8, columns 8 j + 2 t and + 1 (j < 16).  Returns the
    write count of every (output, image, row, column)."""
    writes = np.zeros((2, B, N, 128), int)
    for b in range(B):
        for by in range(N // fused_twoway.KV_ROW_TILE):
            r0 = by * fused_twoway.KV_ROW_TILE
            for tid in range(256):
                warp, lane = tid >> 5, tid & 31
                wg, wi, g, t = warp >> 2, warp & 3, lane >> 2, lane & 3
                if wi * 16 >= fused_twoway.KV_ROW_TILE:
                    continue
                for half in range(2):
                    for j in range(16):
                        writes[wg, b, r0 + wi * 16 + g + 8 * half, 8 * j + 2 * t:8 * j + 2 * t + 2] += 1
    return writes


@pytest.mark.parametrize("N", [4096, fused_twoway.KV_ROW_TILE])
def test_kv_mapping_writes_every_row_once(N):
    """At the main path's 4096 rows (128 blocks) and at the fewest rows the
    wrapper takes, every K and V output is written once."""
    fused_twoway.check_kv_layout(1, N)
    assert (_kv_block_writes(1, N) == 1).all()


def test_kv_wrapper_refuses_before_building(monkeypatch):
    """K4 refuses N off its 32-row block and unaligned operands; a CPU
    tensor runs the plain version and counts nothing."""
    calls = []
    _fake_build(monkeypatch, calls)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_twoway.check_kv_layout(1, 48)
    with pytest.raises(ValueError, match="aligned"):
        fused_twoway.check_kv_layout(1, 64, (0x1008,))
    keys = torch.zeros(1, 48, 256)
    w = (torch.zeros(128, 256), torch.zeros(128), torch.zeros(128, 256), torch.zeros(128))
    with pytest.raises(ValueError):
        fused_twoway.t2i_kv_proj_cuda(keys, torch.zeros(48, 256), *w)
    assert calls == [] and fused_twoway.kv_launches == 0
    monkeypatch.undo()
    monkeypatch.setattr(fused_twoway, "kv_launches", 0)
    k, v = fused_twoway.t2i_kv_proj(torch.zeros(1, 64, 256), torch.zeros(64, 256), *w)
    assert k.dtype == torch.bfloat16 and tuple(v.shape) == (1, 64, 128)
    assert fused_twoway.kv_launches == 0
