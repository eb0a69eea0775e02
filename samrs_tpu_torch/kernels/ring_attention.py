"""Ring attention: exact attention over a token axis split across ranks
(mirrors samrs_tpu/kernels/ring_attention.py).

Each rank keeps its chunk of the queries; the K / V chunks go around the
ring of the mesh's ranks, each rank sending its current chunk to rank + 1
and receiving the next from rank - 1 in one batched ``isend`` / ``irecv``
pair (JAX's ``ppermute`` with ``perm = [(j, (j + 1) % size)]``; the pair
cannot deadlock as two blocking sends would).  The transfer of the next
chunk is in flight while this one is worked on.  The partials merge with
the online ``(m, l, o)`` recurrence in fp32 (JAX :60-82, :109-131); a bias
is taken a chunk of columns at a time, and SAM's decomposed rel-pos bias is
gathered per chunk from its rows (``cols // W``, ``cols % W``): no ``(N,
N)`` bias is built.  Memory a rank: O(N / ranks) activations and one
chunk's (N / ranks)^2 logits.

The chunk attention is plain PyTorch, as JAX's ``_chunk_attention`` is
plain jnp (no ``pallas_call`` behind it).  It rounds as K2 does, the
encoder's one-card kernel that the ring replaces on the global blocks: fp32
logits ``(q . k) * scale + rel_h + rel_w``, and probabilities rounded to
the dtype of ``v`` relative to the running maximum after each 128-key tile
in key order (``flash_attention.online_softmax_v``).  That maximum depends
on chunks a rank has not seen yet, so a first rotation of K alone
gathers the logits' maximum of every key tile; the second carries K and V
and computes the partials.  In fp32 the probabilities are not rounded and
the result is exact attention, as JAX's.

``ring_attention`` / ``ring_attention_relpos`` take this rank's chunks;
``sp_attention`` / ``sp_flash_attention_relpos`` take the whole sequence
(replicated on every rank), run the ring on the rank's rows and return the
whole output (one all-gather).  The JAX ``mesh`` / ``axis_name`` is the
port's ``DataMesh`` (core/mesh.py): its ranks share the token rows.

Transport: over NCCL (one card a rank) the chunks go device to device; a
CUDA tensor under gloo (ranks that share one card) is staged through the
host, because gloo's send / recv take host memory.  ``transport(mesh,
device)`` names the one that runs.

Collectives of one global block of the sequence-parallel SAM encoder
(sam/image_encoder.py): ranks - 1 rotations of K (the tile maxima), ranks - 1
rotations of K and V (one stacked tensor each), and one all-gather of the
block's output rows.

No backward: no JAX entry point trains through the sequence-parallel
encoder, and an input that requires a gradient raises.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from samrs_tpu_torch.core.mesh import DataMesh
from samrs_tpu_torch.kernels.flash_attention import K2_KEY_TILE

AddBias = Callable[[torch.Tensor, int], torch.Tensor]  # (logits of chunk src, src) -> logits


def _world(mesh: Optional[DataMesh]) -> Tuple[int, int]:
    return (0, 1) if mesh is None else (mesh.rank, mesh.world)


def _staged(mesh: Optional[DataMesh], device) -> bool:
    """Whether a tensor on `device` crosses the ranks through the host (CUDA under gloo)."""
    return (mesh is not None and mesh.world > 1 and torch.device(device).type == "cuda"
            and mesh.backend == "gloo")


def transport(mesh: Optional[DataMesh], device) -> str:
    """How the ring moves a chunk on `device`: "device to device" or "through the host"."""
    return "through the host" if _staged(mesh, device) else "device to device"


def _no_grad(*ts: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError("ring attention has no backward: run it under torch.no_grad() (no "
                           "entry point trains through the sequence-parallel SAM encoder)")


def ring_chunks(t: torch.Tensor, mesh: Optional[DataMesh]) -> Iterator[Tuple[int, torch.Tensor]]:
    """(source rank, chunk) of `t` as it goes round the ring: this rank's own
    chunk first, then rank - 1's, rank - 2's, ...; the next chunk is in
    flight while the caller works on the one yielded."""
    rank, world = _world(mesh)
    host = _staged(mesh, t.device)
    cur = t
    for step in range(world):
        reqs, buf = [], None
        if step < world - 1:
            send = cur.cpu() if host else cur.contiguous()
            buf = torch.empty_like(send)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, (rank + 1) % world),
                                           dist.P2POp(dist.irecv, buf, (rank - 1) % world)])
        yield (rank - step) % world, cur
        for r in reqs:
            r.wait()
        if buf is not None:
            cur = buf.to(t.device) if host else buf


def gather_rows(t: torch.Tensor, mesh: Optional[DataMesh], dim: int) -> torch.Tensor:
    """The ranks' `t` concatenated along `dim` in rank order (one all-gather;
    through the host for a CUDA tensor under gloo)."""
    rank, world = _world(mesh)
    if world == 1:
        return t
    src = t.cpu() if _staged(mesh, t.device) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim).to(t.device)


def _tiles(start: int, n: int, tile: int = K2_KEY_TILE) -> Tuple[int, int, int]:
    """Keys [start, start + n) in K2's key tiles: (first tile, keys of the
    first tile before `start`, number of tiles)."""
    first = start // tile
    lead = start - first * tile
    return first, lead, -(-(lead + n) // tile)


def _tiled(s: torch.Tensor, lead: int, count: int, tile: int = K2_KEY_TILE) -> torch.Tensor:
    """(..., n) -> (..., count, tile), padded with -inf to the tiles' bounds."""
    n = s.shape[-1]
    return F.pad(s, (lead, count * tile - lead - n), value=float("-inf")).unflatten(-1, (count, tile))


def _logits(q: torch.Tensor, kc: torch.Tensor, scale: float, add_bias: Optional[AddBias],
            src: int) -> torch.Tensor:
    s = (q.float() @ kc.float().transpose(-1, -2)) * scale
    return s if add_bias is None else add_bias(s, src)


def _ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[DataMesh],
          scale: float, add_bias: Optional[AddBias]) -> torch.Tensor:
    """Attention of this rank's queries over every rank's keys: (B, n, d)
    chunks in, (B, n, d) fp32 out."""
    _no_grad(q, k, v)
    _, world = _world(mesh)
    n = k.shape[-2]
    count = -(-(n * world) // K2_KEY_TILE)
    # rotation 1: the logits' maximum of every key tile, then the running maximum in key order
    tile_max = torch.full(q.shape[:-1] + (count,), float("-inf"), device=q.device)
    for src, kc in ring_chunks(k, mesh):
        first, lead, cnt = _tiles(src * n, n)
        part = _tiled(_logits(q, kc, scale, add_bias, src), lead, cnt).amax(-1)
        tile_max[..., first:first + cnt] = torch.maximum(tile_max[..., first:first + cnt], part)
    ref = tile_max.cummax(-1).values
    # rotation 2: the partials, merged by the online (m, l, o) recurrence
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    m = torch.full(q.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    for src, kvc in ring_chunks(torch.stack([k, v]), mesh):
        kc, vc = kvc.unbind(0)
        first, lead, cnt = _tiles(src * n, n)
        r = ref[..., first:first + cnt]
        mc = r[..., -1]
        p = torch.exp(_tiled(_logits(q, kc, scale, add_bias, src), lead, cnt) - r[..., None])
        p = p.to(v.dtype).float() * torch.exp(r - mc[..., None])[..., None]
        p = p.flatten(-2)[..., lead:lead + n]
        oc, lc = p @ vc.float(), p.sum(-1)
        m_new = torch.maximum(m, mc)
        c_old, c_new = torch.exp(m - m_new), torch.exp(mc - m_new)
        o = o * c_old[..., None] + oc * c_new[..., None]
        l = l * c_old + lc * c_new
        m = m_new
    return o / l[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[DataMesh],
                   scale: float, bias_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact softmax attention with K / V going round `mesh`'s ring.  q, k, v
    (B, N_local, d): this rank's chunk of the sequence (rank r holds tokens
    r * N_local ...); bias_rows: optional (B, N_local, N_global), this
    rank's query rows of the whole bias, sliced per chunk.  Returns
    (B, N_local, d) fp32."""
    _no_grad(bias_rows)
    n = k.shape[-2]
    add = None if bias_rows is None else (
        lambda s, src: s + bias_rows[..., src * n:(src + 1) * n].float())
    return _ring(q, k, v, mesh, scale, add)


def relpos_columns(rel_h: torch.Tensor, rel_w: torch.Tensor, grid_w: int, start: int,
                   n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposed rel-pos terms of key columns [start, start + n): rel_h
    at row cols // W and rel_w at column cols % W, each (..., n)."""
    cols = torch.arange(start, start + n, device=rel_h.device)
    return (rel_h.index_select(-1, torch.div(cols, grid_w, rounding_mode="floor")),
            rel_w.index_select(-1, cols % grid_w))


def ring_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                          rel_w: torch.Tensor, grid_w: int, mesh: Optional[DataMesh],
                          scale: float) -> torch.Tensor:
    """Ring attention with SAM's decomposed rel-pos bias, s[q, c] = q.k *
    scale + rel_h[q, c // W] + rel_w[q, c % W] (added in that order, as K2
    adds them).  q, k, v (B, N_local, d) local chunks; rel_h (B, N_local,
    Kh) and rel_w (B, N_local, Kw) this rank's query rows of the tables.
    Returns (B, N_local, d) fp32."""
    _no_grad(rel_h, rel_w)
    n = k.shape[-2]

    def add(s, src):
        h, w = relpos_columns(rel_h.float(), rel_w.float(), grid_w, src * n, n)
        return s + h + w

    return _ring(q, k, v, mesh, scale, add)


def rows_per_rank(H: int, mesh: Optional[DataMesh]) -> int:
    """Token rows of a rank's slab of an H-row grid; raises unless the ranks
    divide H (JAX asserts the same)."""
    _, world = _world(mesh)
    if H % world:
        raise ValueError(f"token rows {H} must divide among the {world} ranks of the sequence mesh")
    return H // world


def relpos_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, Rh: torch.Tensor,
                Rw: torch.Tensor, hw: Tuple[int, int], scale: float,
                mesh: Optional[DataMesh]) -> torch.Tensor:
    """The body of ``sp_flash_attention_relpos`` on this rank's slab of
    token rows: q, k, v (B, h_local * W, d), the rank's rows
    [rank * h_local, (rank + 1) * h_local) of the (H, W) grid; this rank's
    rel_h rows from its own queries and its rows of Rh (JAX :190-201), rel_w
    from all of Rw, then the ring.  Returns (B, h_local * W, d) fp32."""
    H, W = hw
    rank, _ = _world(mesh)
    hl = rows_per_rank(H, mesh)
    B, nl, d = q.shape
    if nl != hl * W:
        raise ValueError(f"q: expected {hl * W} tokens ({hl} rows of {W}) a rank, got {nl}")
    _no_grad(q, Rh, Rw)
    rq = q.float().reshape(B, hl, W, d)
    rel_h = torch.einsum("bxyd,xkd->bxyk", rq, Rh[rank * hl:(rank + 1) * hl].float())
    rel_w = torch.einsum("bxyd,ykd->bxyk", rq, Rw.float())
    return ring_attention_relpos(q, k, v, rel_h.reshape(B, nl, H), rel_w.reshape(B, nl, W), W,
                                 mesh, scale)


def _local(t: torch.Tensor, mesh: Optional[DataMesh], dim: int = 1) -> torch.Tensor:
    rank, world = _world(mesh)
    if t.shape[dim] % world:
        raise ValueError(f"{t.shape[dim]} tokens do not divide among {world} ranks")
    return t.chunk(world, dim)[rank]


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[DataMesh],
                 scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention of whole (B, N, d) q / k / v (and an
    optional (B, N, N) bias), the same on every rank: the rank's chunk of N
    runs the ring, and the chunks are gathered back.  Returns (B, N, d) fp32
    on every rank."""
    local = ring_attention(_local(q, mesh), _local(k, mesh), _local(v, mesh), mesh, scale,
                           None if bias is None else _local(bias, mesh))
    return gather_rows(local, mesh, 1)


def sp_flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int],
                              scale: float, mesh: Optional[DataMesh]) -> torch.Tensor:
    """Sequence-parallel drop-in for ``flash_attention_relpos`` (the same
    arguments plus the mesh): whole (B, N, d) q / k / v on every rank, the
    token axis (row-major H rows) split among the ranks, each running
    ``relpos_ring`` on its rows; returns the whole (B, N, d) fp32 output.
    Raises unless the ranks divide H."""
    H, W = hw
    hl = rows_per_rank(H, mesh)
    rank, _ = _world(mesh)
    rows = slice(rank * hl * W, (rank + 1) * hl * W)
    local = relpos_ring(q[:, rows], k[:, rows], v[:, rows], Rh, Rw, hw, scale, mesh)
    return gather_rows(local, mesh, 1)
