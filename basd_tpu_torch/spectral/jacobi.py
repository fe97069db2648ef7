"""Batch-parallel cyclic Jacobi symmetric eigensolver in plain torch: the
plain versions of the Jacobi eigh and eigenvalues kernels
(`spectral/jacobi_kernel.py`).

Counterpart of `basd_tpu/spectral/jacobi.py` (and of the eigenvalues-only
`pallas_jacobi_eigvals`). One parallel-order step
rotates the n/2 disjoint pairs (i, i + h), h = n/2, of every matrix in the
batch at once; the pairs are the contiguous top and bottom halves, so the
rotations are elementwise combinations of two halves. Between steps the
half-shift round-robin permutation

    new = [x_0, x_h, x_1..x_{h-2}, x_{h+1}..x_{n-1}, x_{h-1}]

makes every pair meet exactly once per sweep of n - 1 steps.
"""

from __future__ import annotations

import functools

import torch


def rotate_positions(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Half-shift round-robin permutation along `dim` (see module doc)."""
    n = x.shape[dim]
    h = n // 2
    sl = lambda lo, hi: x.narrow(dim, lo, hi - lo)
    return torch.cat(
        [sl(0, 1), sl(h, h + 1), sl(1, h - 1), sl(h + 1, n), sl(h - 1, h)],
        dim=dim,
    )


def diag_of(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1)


def pair_rotations(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Jacobi (c, s), each (B, h), for the half-shift pairs (i, i + h)."""
    n = a.shape[-1]
    h = n // 2
    d = diag_of(a)
    app = d[:, :h]
    aqq = d[:, h:]
    apq = torch.diagonal(a[:, :h, h:], dim1=-2, dim2=-1)  # a[i, i + h]
    return rotations(app, aqq, apq)


def rotations(
    app: torch.Tensor, aqq: torch.Tensor, apq: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """`pair_rotations`' (c, s) from each pair's a_pp, a_qq and a_pq."""
    safe = apq.abs() > 1e-30
    tau = (aqq - app) / torch.where(safe, 2.0 * apq, torch.ones_like(apq))
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(safe, c, torch.ones_like(c))
    s = torch.where(safe, s, torch.zeros_like(s))
    return c, s


def apply_rows(a: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """row_i' = c row_i - s row_{i+h}; row_{i+h}' = s row_i + c row_{i+h}."""
    h = a.shape[1] // 2
    top, bot = a[:, :h], a[:, h:]
    cc, ss = c[:, :, None], s[:, :, None]
    return torch.cat([cc * top - ss * bot, ss * top + cc * bot], dim=1)


def apply_cols(a: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    h = a.shape[2] // 2
    left, right = a[:, :, :h], a[:, :, h:]
    cc, ss = c[:, None, :], s[:, None, :]
    return torch.cat([cc * left - ss * right, ss * left + cc * right], dim=2)


def jacobi_step(
    a: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    c, s = pair_rotations(a)
    a = apply_cols(apply_rows(a, c, s), c, s)
    v = apply_cols(v, c, s)
    a = rotate_positions(rotate_positions(a, 1), 2)
    v = rotate_positions(v, 2)
    return a, v


# ---------------------------------------------------------------------------
# The layout of the Jacobi eigh kernel's ping-pong route (n <= 96): A and
# V^T stay in logical order and each step writes the rotated values
# straight to the next step's positions in a second buffer.
# ---------------------------------------------------------------------------


def halfshift_dst(n: int) -> list[int]:
    """dst[p]: the position that `rotate_positions` moves position p to,
    the inverse of the half-shift (0 -> 0, h -> 1, p -> p + 1 for
    1 <= p <= h - 2, h - 1 -> n - 1, p -> p - 1 for h < p < n)."""
    h = n // 2

    def dst(p: int) -> int:
        if p == 0:
            return 0
        if p == h:
            return 1
        if p == h - 1:
            return n - 1
        return p + 1 if p < h - 1 else p - 1

    return [dst(p) for p in range(n)]


def halfshift_src(n: int) -> list[int]:
    """src[k]: the position that `rotate_positions` moves to position k,
    the inverse of `halfshift_dst` (0, h, 1..h-2, h+1..n-1, h-1), in the
    closed form the kernel computes."""
    h = n // 2

    def src(k: int) -> int:
        if k == 0:
            return 0
        if k == 1:
            return h
        if k == n - 1:
            return h - 1
        return k - 1 if k < h else k + 1

    return [src(k) for k in range(n)]


def pingpong_pair_inputs(
    a: torch.Tensor, c: torch.Tensor, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each pair k's next a_kk, a_{k+h,k+h} and a_{k,k+h}, each (B, h), as
    the ping-pong route's rotation lanes compute them from this step's A
    and rotations (c, s): the entry of a rotated 2x2 block that lands
    there, an entry in a block's bottom row or right column taken as the
    top or left one with its operands swapped and s negated (s x + c y is
    c y - (-s) x, bit for bit). The bits of the next A's entries."""
    n = a.shape[-1]
    h = n // 2
    src = torch.tensor(halfshift_src(n), device=a.device)

    def pair(x):
        return torch.where(x < h, x, x - h)

    def other(x):
        return torch.where(x < h, x + h, x - h)

    def entry(p, q):
        cr, sr = c[:, pair(p)], torch.where(p < h, s[:, pair(p)], -s[:, pair(p)])
        cq, sq = c[:, pair(q)], torch.where(q < h, s[:, pair(q)], -s[:, pair(q)])

        def rows(col):
            return cr * a[:, p, col] - sr * a[:, other(p), col]

        return cq * rows(q) - sq * rows(other(q))

    p1, p2 = src[:h], src[h:]
    return entry(p1, p1), entry(p2, p2), entry(p1, p2)


def pingpong_step(
    a: torch.Tensor, vt: torch.Tensor, c: torch.Tensor, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of `jacobi_step` on (A, V^T) as the ping-pong route runs
    it, given the step's rotations (c, s) (`pair_rotations` of A): the 2x2
    block (ri, ci) of A, rows {ri, ri + h} x columns {ci, ci + h}, rotated
    rows first and then columns, scattered to rows dst(ri), dst(ri + h) and
    columns dst(ci), dst(ci + h) of a new buffer; V^T's rows ri, ri + h
    rotated and scattered to rows dst(ri), dst(ri + h); and the next
    step's rotations from `pingpong_pair_inputs`. Returns the next A and
    V^T (the bits of `jacobi_step`) and rotations (the bits of
    `pair_rotations` on the next A)."""
    n = a.shape[-1]
    h = n // 2
    dst = torch.tensor(halfshift_dst(n), device=a.device)
    cr, sr = c[:, :, None], s[:, :, None]  # the row pair ri
    cc, sc = c[:, None, :], s[:, None, :]  # the column pair ci
    a00, a01, a10, a11 = a[:, :h, :h], a[:, :h, h:], a[:, h:, :h], a[:, h:, h:]
    t0, t1 = cr * a00 - sr * a10, cr * a01 - sr * a11
    b0, b1 = sr * a00 + cr * a10, sr * a01 + cr * a11
    r0, r1 = dst[:h, None], dst[h:, None]
    c0, c1 = dst[None, :h], dst[None, h:]
    a_next = torch.empty_like(a)
    a_next[:, r0, c0] = cc * t0 - sc * t1
    a_next[:, r0, c1] = sc * t0 + cc * t1
    a_next[:, r1, c0] = cc * b0 - sc * b1
    a_next[:, r1, c1] = sc * b0 + cc * b1
    return (a_next, vt_step(vt, c, s), *rotations(*pingpong_pair_inputs(a, c, s)))


def vt_step(vt: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One step of V^T <- J^T V^T with the step's rotations (c, s), each
    (B, h): rows k and k + h of every column rotated (`apply_cols`' formula
    on V) and moved to rows dst(k), dst(k + h) (`halfshift_dst`), as the
    ping-pong route and the packed_log route's replay move them. With
    `pair_rotations`' (c, s) of each step, the bits of `jacobi_step`'s V."""
    h = c.shape[-1]
    dst = torch.tensor(halfshift_dst(2 * h), device=vt.device)
    cr, sr = c[:, :, None], s[:, :, None]
    top, bot = vt[:, :h], vt[:, h:]
    vt_next = torch.empty_like(vt)
    vt_next[:, dst[:h]] = cr * top - sr * bot
    vt_next[:, dst[h:]] = sr * top + cr * bot
    return vt_next


def replay_vt(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """V^T rebuilt from a rotation log (c, s), each (B, steps, h), step t's
    row holding the rotations that step t applies: the identity taken
    through `vt_step` once per step, as the packed_log route's second launch
    (`jacobi_vt_replay_kernel`) runs it on each column. Its rows end in the
    position order of the run's final diagonal."""
    b, steps, h = c.shape
    vt = torch.eye(2 * h, dtype=c.dtype, device=c.device).expand(b, 2 * h, 2 * h)
    for t in range(steps):
        vt = vt_step(vt, c[:, t], s[:, t])
    return vt


# ---------------------------------------------------------------------------
# The layout of the Jacobi eigenvalues kernel's packed route (K5, n <= 238):
# the symmetric A held as its upper block triangle, each entry once, in two
# buffers; each step writes the rotated entries straight to their next
# positions, transposed where those fall below the diagonal.
# ---------------------------------------------------------------------------


def packed_blocks(n: int) -> tuple[list[int], list[int]]:
    """(R, C) of the blocks R <= C of the h x h grid of 2x2 blocks (rows
    {R, R + h} x columns {C, C + h}), in the kernel's row-major order."""
    h = n // 2
    rows = [r for r in range(h) for _ in range(r, h)]
    cols = [c for r in range(h) for c in range(r, h)]
    return rows, cols


def packed_slot(p: int, q: int, n: int) -> int:
    """The slot that holds entry (p, q) (either order): plane 2 i + j of
    m = h (h + 1) / 2 floats, i = (p >= h), j = (q >= h), at the block
    (pair(p), pair(q)) with pair(p) <= pair(q); in a diagonal block the
    upper entry (R, R + h), plane TR."""
    h = n // 2
    r, c = p % h, q % h
    if r > c or (r == c and p > q):
        p, q, r, c = q, p, c, r
    return (2 * (p >= h) + (q >= h)) * (h * (h + 1) // 2) + r * h - r * (r - 1) // 2 + c - r


def packed_positions(n: int) -> tuple[list[int], list[int]]:
    """(p, q) of each of the 4 m slots, plane by plane (TL, TR, BL, BR):
    slot 2 i + j of block (R, C) is entry (R + i h, C + j h). A diagonal
    block's BL slot is (R + h, R), the mirror of its TR, which the kernel
    never reads (`packed_read_slots`)."""
    h = n // 2
    rows, cols = packed_blocks(n)
    ps, qs = [], []
    for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ps += [r + i * h for r in rows]
        qs += [c + j * h for c in cols]
    return ps, qs


def packed_read_slots(n: int) -> list[int]:
    """The slot that the kernel reads for each slot: itself, but a diagonal
    block's BL is read from its TR."""
    ps, qs = packed_positions(n)
    return [packed_slot(p, q, n) for p, q in zip(ps, qs)]


def packed_dst(n: int) -> list[int]:
    """dst[slot]: the slot of the next buffer that the rotated entry of
    `slot` goes to, the canonical slot of (dst(p), dst(q)); -1 for a
    diagonal block's BL, which is not written (its canonical slot is its
    TR's)."""
    dst = halfshift_dst(n)
    ps, qs = packed_positions(n)
    h = n // 2
    return [-1 if p % h == q % h and p > q else packed_slot(dst[p], dst[q], n)
            for p, q in zip(ps, qs)]


def pack_upper(a: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> (B, 4 m): every slot's entry (a diagonal block's BL the
    entry of its TR, as the kernel reads it)."""
    n = a.shape[-1]
    ps, qs = packed_positions(n)
    read = torch.tensor(packed_read_slots(n), device=a.device)
    return a[:, torch.tensor(ps, device=a.device), torch.tensor(qs, device=a.device)][:, read]


def packed_diag(x: torch.Tensor, n: int) -> torch.Tensor:
    """The diagonal of a packed A: a_ii from TL (i < h) or BR of block (i mod h)."""
    return x[:, torch.tensor([packed_slot(i, i, n) for i in range(n)], device=x.device)]


def _packed_rot(c, s, x, y):
    """c x - s y as the packed route's mirror rounds it; s x + c y is
    _packed_rot(c, -s, y, x), bit for bit."""
    return c * x - s * y


@functools.lru_cache(maxsize=None)
def _packed_tables(n: int) -> dict:
    """The index tensors (on the CPU) of `packed_step` and
    `packed_pair_inputs` at n, built once per n: the blocks' row and column
    pairs, each slot's next slot (`packed_dst`) and which are written, the
    slots the kernel reads, and for each of the rotation lanes' three
    entries its four slots, row and column pairs and signs."""
    h = n // 2
    rows, cols = packed_blocks(n)
    dst = torch.tensor(packed_dst(n))
    src = halfshift_src(n)
    read = packed_read_slots(n)
    p1, p2 = src[:h], src[h:]
    entries = []
    for ps, qs in ((p1, p1), (p2, p2), (p1, p2)):
        slots, er, ec, gr, gc = [[], [], [], []], [], [], [], []
        for p, q in zip(ps, qs):
            if p % h > q % h or (p % h == q % h and p > q):
                p, q = q, p
            i, j = p // h, q // h
            row, col = p % h, q % h
            for k, (u, v) in enumerate(((i, j), (1 - i, j), (i, 1 - j), (1 - i, 1 - j))):
                slots[k].append(read[packed_slot(row + u * h, col + v * h, n)])
            er.append(row)
            ec.append(col)
            gr.append(-1.0 if i else 1.0)
            gc.append(-1.0 if j else 1.0)
        entries.append(tuple(torch.tensor(v) for v in (*slots, er, ec, gr, gc)))
    return dict(rows=torch.tensor(rows), cols=torch.tensor(cols), dst=dst,
                keep=dst >= 0, read=torch.tensor(read), entries=entries)


def packed_pair_inputs(
    x: torch.Tensor, c: torch.Tensor, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each pair k's next a_kk, a_{k+h,k+h} and a_{k,k+h}, each (B, h), as
    the packed route's rotation lanes compute them from this step's packed
    A and rotations (c, s): the canonical entry of (src(k), src(k)),
    (src(k + h), src(k + h)) and (src(k), src(k + h)), plane (i, j) of its
    block, rotated from the block's four slots with the row pair's s times
    -1 for a bottom row and the column pair's for a right column."""
    tables = _packed_tables(2 * c.shape[-1])

    def entry(e):
        *slots, rows, cols, gr, gc = (t.to(x.device) for t in e)
        ins = [x[:, sl] for sl in slots]
        sr, sc = s[:, rows] * gr, s[:, cols] * gc
        cr, cc = c[:, rows], c[:, cols]
        return _packed_rot(cc, sc, _packed_rot(cr, sr, ins[0], ins[1]),
                           _packed_rot(cr, sr, ins[2], ins[3]))

    return tuple(entry(e) for e in tables["entries"])


def packed_step(
    x: torch.Tensor, c: torch.Tensor, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the packed route on a packed A (B, 4 m) with the step's
    rotations (c, s), each (B, h): every block (R, C) rotated, rows by pair
    R and columns by pair C (`jacobi_step`'s formula, from the slots the
    kernel reads), and each rotated entry scattered to `packed_dst`; a
    diagonal block's BL slot then holds its TR, as the kernel reads it
    (`pack_upper`'s layout). Returns the next packed A and the
    next rotations from `packed_pair_inputs`. On a symmetric A the written
    slots hold the bits of `jacobi_step`'s entries there."""
    h = c.shape[-1]
    m = h * (h + 1) // 2
    t = {k: v.to(x.device) for k, v in _packed_tables(2 * h).items() if k != "entries"}
    rows, cols = t["rows"], t["cols"]
    a00, a01, a10, a11 = (x[:, q * m:(q + 1) * m] for q in range(4))
    cr, sr, cc, sc = c[:, rows], s[:, rows], c[:, cols], s[:, cols]
    t0, t1 = _packed_rot(cr, sr, a00, a10), _packed_rot(cr, sr, a01, a11)
    b0, b1 = _packed_rot(cr, -sr, a10, a00), _packed_rot(cr, -sr, a11, a01)
    vals = torch.cat([_packed_rot(cc, sc, t0, t1), _packed_rot(cc, -sc, t1, t0),
                      _packed_rot(cc, sc, b0, b1), _packed_rot(cc, -sc, b1, b0)], dim=1)
    keep = t["keep"]
    nxt = torch.zeros_like(x)
    nxt[:, t["dst"][keep]] = vals[:, keep]
    nxt = nxt[:, t["read"]]
    return (nxt, *rotations(*packed_pair_inputs(x, c, s)))


def _sort_desc(
    w: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(-w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[:, None, :].expand(v.shape))
    return w, v


def _strip_pad(
    w: torch.Tensor, v: torch.Tensor, n0: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the decoupled padding direction (eigenvalue 0, vector e_n)."""
    n = w.shape[-1]
    pad_idx = torch.argmax(v[:, n0, :].abs(), dim=-1)
    keep = torch.arange(n, device=w.device)[None, :] != pad_idx[:, None]
    order0 = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :n0]
    w = torch.gather(w, -1, order0)
    v = torch.gather(v[:, :n0, :], -1, order0[:, None, :].expand(-1, n0, -1))
    return w, v


def symmetrize_pad(a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(..., n0, n0) -> ((B, n, n) fp32 symmetric, padded to even n; n0)."""
    n0 = a.shape[-1]
    a = a.reshape(-1, n0, n0).to(torch.float32)
    a = (a + a.transpose(-1, -2)) * 0.5
    if n0 % 2:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    return a, n0


def finish(
    w: torch.Tensor, v: torch.Tensor, n0: int, batch_shape, sort: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Strip an odd-n pad, sort descending, restore the batch shape."""
    if w.shape[-1] != n0:
        w, v = _strip_pad(w, v, n0)
    if sort:
        w, v = _sort_desc(w, v)
    return w.reshape(*batch_shape, n0), v.reshape(*batch_shape, n0, n0)


def jacobi_eigh(
    a: torch.Tensor, *, sweeps: int = 10, sort: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of (..., n, n), batch-parallel.

    Returns (eigvals, eigvecs) with eigvecs[..., :, i] the i-th
    eigenvector; descending eigenvalue order when sort=True. Odd n is
    padded internally (the pad direction decouples exactly)."""
    batch_shape = a.shape[:-2]
    a, n0 = symmetrize_pad(a)
    b, n = a.shape[0], a.shape[-1]
    v = torch.eye(n, dtype=torch.float32, device=a.device).expand(b, n, n)
    for _ in range((n - 1) * sweeps):
        a, v = jacobi_step(a, v)
    return finish(diag_of(a), v, n0, batch_shape, sort)


def finish_eigvals(w: torch.Tensor, n0: int, batch_shape) -> torch.Tensor:
    """Sort ascending; an odd n's pad contributes one zero eigenvalue,
    dropped as the entry of smallest |w|; restore the batch shape."""
    w = torch.sort(w, dim=-1).values
    n = w.shape[-1]
    if n != n0:
        drop = torch.argmin(w.abs(), dim=-1)
        keep = torch.arange(n, device=w.device)[None, :] != drop[:, None]
        order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :n0]
        w = torch.sort(torch.gather(w, -1, order), dim=-1).values
    return w.reshape(*batch_shape, n0)


def jacobi_eigvals(a: torch.Tensor, *, sweeps: int = 9) -> torch.Tensor:
    """Eigenvalues only (ascending, eigvalsh-compatible) of (..., n, n):
    the plain version of the Jacobi eigenvalues kernel, K3's rotations
    without the eigenvector accumulator (counterpart of
    `pallas_jacobi_eigvals`)."""
    batch_shape = a.shape[:-2]
    a, n0 = symmetrize_pad(a)
    for _ in range((a.shape[-1] - 1) * sweeps):
        c, s = pair_rotations(a)
        a = apply_cols(apply_rows(a, c, s), c, s)
        a = rotate_positions(rotate_positions(a, 1), 2)
    return finish_eigvals(diag_of(a), n0, batch_shape)
