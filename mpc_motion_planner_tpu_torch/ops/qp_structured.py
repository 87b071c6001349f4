"""Structured (matrix-free) boxADMM for the transcribed OCP QPs (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/qp_structured.py``: structured
Ruiz equilibration, assembly of the node-major block-banded KKT matrix
M = D A' diag(w) A D + diag(sig) with its arrow column for the time
parameter, the node-level block-banded Cholesky with its jitter retry, and
the ADMM loop.

The loop here is the plain version of kernel 3 and follows the fused
kernel's semantics (``ops/pallas/structured_admm.py`` ``_structured_kernel``)
exactly: rho fixed within a dispatch, ``kkt_refine`` steps of iterative
refinement on every KKT solve, the flush-to-zero/±1e15 clamp on every
updated iterate, the ±1e20 stand-ins for infinite bounds, residual checks
every ``check_every`` iterations and at the end of a dispatch, a NaN-safe
freeze at magnitude 1e12 (done=2), and per-problem counts of active
iterations. Each problem stops on its own ``done``. Adaptive rho runs as
the fused kernel's host loop runs it (:func:`admm_chunked`): dispatches of
``rho_update_every`` iterations with the per-problem rho rescaled by the
residual ratio, and everything that depends on rho rebuilt and refactored,
between them. The functions take the caller's dtype, so the CPU tests run
it at float64.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .qp import _HARD, QPSettings, QPSolution, _rho_pattern, _soft_prox
from .structure import StructuredA, apply_A, apply_AT, static_index_tensors

_PIV_FLOOR = 1e-20  # kernel 2's Cholesky pivot floor
_SAT = 0.99e8  # kernel 2's saturation flag level
_BIG = 1e12  # divergence freeze level


def _node_cover(order: int, num_segments: int, device):
    """Per-node covering segments (sA, locA) and, for shared boundary
    nodes, (sB, locB), with valid2 (float64), on ``device``."""
    _, first, second, valid2 = static_index_tensors(order, num_segments, device)
    K = order + 1
    return first // K, first % K, second // K, second % K, valid2


def split_node_major(ocp, v):
    """(B, num_var) z-layout -> ((B, nodes, nx+nu), (B,) p)."""
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    B = v.shape[0]
    X = v[:, : nodes * nx].reshape(B, nodes, nx)
    U = v[:, nodes * nx : nodes * (nx + nu)].reshape(B, nodes, nu)
    return torch.cat([X, U], dim=-1), v[:, nodes * (nx + nu)]


def join_node_major(ocp, vb, vp):
    """Inverse of :func:`split_node_major`."""
    nx, nu = ocp.nx, ocp.nu
    B = vb.shape[0]
    return torch.cat(
        [vb[..., :nx].reshape(B, -1), vb[..., nx : nx + nu].reshape(B, -1), vp[:, None]],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Structured Ruiz equilibration
# ---------------------------------------------------------------------------


def ruiz_structured(ocp, sa: StructuredA, iters: int):
    """Inf-norm Ruiz scaling of A from its sparsity structure. Returns
    (D (B, n), E (B, m))."""
    order, S, nodes = ocp.coll.order, ocp.coll.num_segments, ocp.num_nodes
    nx, nu, ng, nq = ocp.nx, ocp.nu, ocp.ng, ocp.nq
    K, blk = order + 1, nx + nu
    B = sa.p.shape[0]
    dt, dev = sa.f_rows.dtype, sa.f_rows.device

    idx = ocp.segment_index(dev)
    sA, lA, sB, lB, has2 = _node_cover(order, S, dev)
    h2 = has2.to(dt)[None, :, None]

    absDm = ocp.coll.diff_matrix.to(dt).abs()  # (K, K)
    p = sa.p.abs()
    absf = sa.f_rows.abs().reshape(B, S, K, nx)
    absJ = sa.J.abs()

    d_nodes = torch.ones(B, nodes, blk, dtype=dt, device=dev)
    d_p = torch.ones(B, dtype=dt, device=dev)
    e_eq = torch.ones(B, S, K, nx, dtype=dt, device=dev)
    e_g = torch.ones(B, nodes, ng, dtype=dt, device=dev)

    def scale(norm):
        return torch.where(
            norm > 1e-10, 1.0 / torch.sqrt(torch.clamp(norm, min=1e-10)),
            torch.ones_like(norm),
        )

    node_ar = torch.arange(nodes, device=dev)
    for _ in range(iters):
        # ---- row inf-norms of E A D ----
        d_seg = d_nodes[:, idx, :nx]  # (B, S, K, nx)
        m_diff = (absDm[None, None, :, :, None] * d_seg[:, :, None, :, :]).amax(dim=3)
        d_v = d_nodes[:, idx, nq : nq + nx]
        r_eq = e_eq * torch.maximum(
            torch.maximum(m_diff, p[:, None, None, None] * d_v),
            absf * d_p[:, None, None, None],
        )
        r_g = e_g * (absJ * d_nodes[:, :, None, :]).amax(dim=-1)

        # ---- column inf-norms of E A D ----
        def eq_col_contrib(s_, l_):
            e_cov = e_eq[:, s_]  # (B, nodes, K, nx)
            cD = (absDm.T[l_][None, :, :, None] * e_cov).amax(dim=2)
            e_row = e_cov[:, node_ar, l_]  # (B, nodes, nx)
            return cD, p[:, None, None] * e_row

        cDA, cVA = eq_col_contrib(sA, lA)
        cDB, cVB = eq_col_contrib(sB, lB)
        cD = torch.maximum(cDA, h2 * cDB)
        cV = torch.maximum(cVA, h2 * cVB)

        c_nodes = torch.zeros(B, nodes, blk, dtype=dt, device=dev)
        c_nodes[..., :nx] = cD
        c_nodes[..., nq : nq + nx] = torch.maximum(c_nodes[..., nq : nq + nx], cV)
        cJ = (absJ * e_g[..., None]).amax(dim=2)
        c_nodes = torch.maximum(c_nodes, cJ) * d_nodes
        c_p = d_p * (absf * e_eq).amax(dim=(1, 2, 3))

        d_nodes = d_nodes * scale(c_nodes)
        d_p = d_p * scale(c_p)
        e_eq = e_eq * scale(r_eq)
        e_g = e_g * scale(r_g)

    D = join_node_major(ocp, d_nodes, d_p)
    E = torch.cat([e_eq.reshape(B, -1), e_g.reshape(B, -1)], dim=-1)
    return D, E


# ---------------------------------------------------------------------------
# Block-banded + arrow assembly / factorization / solve
# ---------------------------------------------------------------------------


def _place(v, rows, cols, blk):
    """Embed per-dim values v (..., L) into (..., blk, blk) blocks."""
    out = v.new_zeros(*v.shape[:-1], blk, blk)
    out[..., rows, cols] = v
    return out


def assemble_banded_M(ocp, sa: StructuredA, w_eq, w_g, D, sig):
    """Banded blocks of M = D A' diag(w) A D + diag(sig) in node-major
    ordering, plus the p arrow column.

    w_eq (B, S, K, nx), w_g (B, nodes, ng): row weights E^2 rho. D, sig
    (B, n) in z-layout. Returns (Mband (B, nodes, bw+1, blk, blk) with
    Mband[b, k, d] = M[node k+d, node k] (d=0 blocks full-symmetric),
    p_col (B, nodes, blk), m_pp (B,))."""
    order, S, nodes = ocp.coll.order, ocp.coll.num_segments, ocp.num_nodes
    nx, nu, nq = ocp.nx, ocp.nu, ocp.nq
    K, blk, bw = order + 1, nx + nu, order
    B = sa.p.shape[0]
    dt, dev = w_eq.dtype, w_eq.device

    Dm = ocp.coll.diff_matrix.to(dt)
    p = sa.p
    f_eq = sa.f_rows.reshape(B, S, K, nx)
    xdim = torch.arange(nx, device=dev)
    vdim = xdim + nq

    d_nodes, d_p = split_node_major(ocp, D)
    sig_nodes, sig_p = split_node_major(ocp, sig)

    Mband = torch.zeros(B, nodes, bw + 1, blk, blk, dtype=dt, device=dev)

    def ncols(l):
        return torch.arange(S, device=dev) * order + l

    # (a) X-X: sum_k w[b,s,k,i] Dm[k,j] Dm[k,l]  (diagonal in i)
    T1 = torch.einsum("bski,kj,kl->bsjli", w_eq, Dm, Dm)
    for j in range(K):
        for l in range(j + 1):
            Mband[:, ncols(l), j - l] += _place(T1[:, :, j, l, :], xdim, xdim, blk)

    # (b) X-V cross: row (s,k,i) couples X(node j, i) with V(node k, i+nq)
    T2 = -p[:, None, None, None, None] * w_eq[:, :, :, None, :] * Dm[None, None, :, :, None]
    for k in range(K):
        for j in range(K):
            val = T2[:, :, k, j, :]
            if j > k:
                Mband[:, ncols(k), j - k] += _place(val, xdim, vdim, blk)
            elif j < k:
                Mband[:, ncols(j), k - j] += _place(val, vdim, xdim, blk)
            else:
                Mband[:, ncols(k), 0] += (
                    _place(val, xdim, vdim, blk) + _place(val, vdim, xdim, blk)
                )

    # (c) V-V: p^2 w on the V diagonal
    T3 = (p**2)[:, None, None, None] * w_eq
    for k in range(K):
        Mband[:, ncols(k), 0] += _place(T3[:, :, k, :], vdim, vdim, blk)

    # (d) inequality rows: per-node J' diag(w_g) J
    Mband[:, :, 0] += torch.einsum("bngc,bng,bnge->bnce", sa.J, w_g, sa.J)

    # ---- column scaling by D (rows of block d live on node k+d) ----
    d_shift = torch.nn.functional.pad(d_nodes, (0, 0, 0, bw))
    for d in range(bw + 1):
        Mband[:, :, d] *= d_shift[:, d : d + nodes, :, None] * d_nodes[:, :, None, :]

    # ---- p arrow ----
    wf = w_eq * f_eq
    pc_X = -torch.einsum("bski,kj->bsji", wf, Dm)
    pc_V = p[:, None, None, None] * wf
    p_col = torch.zeros(B, nodes, blk, dtype=dt, device=dev)
    for j in range(K):
        p_col[:, ncols(j), :nx] += pc_X[:, :, j, :]
    for k in range(K):
        p_col[:, ncols(k), nq : nq + nx] += pc_V[:, :, k, :]
    p_col = p_col * d_p[:, None, None] * d_nodes
    m_pp = (wf * f_eq).sum(dim=(1, 2, 3)) * d_p**2

    # ---- scaled diagonal ----
    Mband[:, :, 0].diagonal(dim1=-2, dim2=-1).add_(sig_nodes)
    return Mband, p_col, m_pp + sig_p


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def banded_cholesky(Mband, bw: int):
    """Node-level block-banded Cholesky M = L L'.

    Returns (Ldi (B, N, blk, blk) inverses of the diagonal factors,
    Lsub (B, N, bw, blk, blk) with Lsub[b, k, d-1] = L[k+d, k] (zero past
    the matrix end), chol_ok (B,) every Cholesky succeeded with pivots above
    the floor)."""
    B, N, _, blk, _ = Mband.shape
    zeros = Mband.new_zeros(B, blk, blk)
    eye = torch.eye(blk, dtype=Mband.dtype, device=Mband.device).expand(B, blk, blk)
    chol_ok = torch.ones(B, dtype=torch.bool, device=Mband.device)
    Lcols = [[None] * bw for _ in range(N)]  # Lcols[k][d-1] = L[k+d, k]
    Ldi = []
    for k in range(N):
        S = Mband[:, k, 0]
        for j in range(max(0, k - bw), k):
            Ljk = Lcols[j][k - j - 1]
            S = S - Ljk @ Ljk.transpose(-1, -2)
        Lkk, info = torch.linalg.cholesky_ex(S)
        piv = torch.diagonal(Lkk, dim1=-2, dim2=-1)
        chol_ok &= (info == 0) & ((piv * piv).amin(-1) > _PIV_FLOOR)
        Linv = torch.linalg.solve_triangular(Lkk, eye, upper=False)
        Ldi.append(Linv)
        for d in range(1, bw + 1):
            if k + d >= N:
                Lcols[k][d - 1] = zeros
                continue
            C = Mband[:, k, d]
            for j in range(max(0, k + d - bw), k):
                C = C - Lcols[j][k + d - j - 1] @ Lcols[j][k - j - 1].transpose(-1, -2)
            Lcols[k][d - 1] = C @ Linv.transpose(-1, -2)
    Lsub = torch.stack([torch.stack(col, dim=1) for col in Lcols], dim=1)
    return torch.stack(Ldi, dim=1), Lsub, chol_ok


def banded_solve(Ldi, Lsub, r):
    """Solve (L L') x = r for node-major r (B, N, blk)."""
    N = r.shape[1]
    bw = Lsub.shape[2]
    ys = []
    for k in range(N):
        acc = r[:, k]
        for d in range(1, min(bw, k) + 1):
            acc = acc - _mv(Lsub[:, k - d, d - 1], ys[k - d])
        ys.append(_mv(Ldi[:, k], acc))
    xs = [None] * N
    for k in range(N - 1, -1, -1):
        acc = ys[k]
        for d in range(1, min(bw, N - 1 - k) + 1):
            acc = acc - _mtv(Lsub[:, k, d - 1], xs[k + d])
        xs[k] = _mtv(Ldi[:, k], acc)
    return torch.stack(xs, dim=1)


def _mv_thirds(M, v):
    """M v with each row's sum taken as kernel 3 takes it: three partial
    sums over the columns i = j, j + 3, ..., added as (s0 + s1) + s2."""
    s = [_mv(M[..., j::3], v[..., j::3]) for j in range(3)]
    return (s[0] + s[1]) + s[2]


def banded_solve_lookahead(Ldi, Lsub, r, thirds: bool = True):
    """:func:`banded_solve` in kernel 3's schedule and order of sums, for
    tests and the GPU smoke check.

    As soon as a sweep knows the vector of node k it forms that node's
    terms of the steps two and three ahead, ``L[k+d,k] y_k`` (forward) and
    ``L[k,k-d]' x_k`` (backward), d = 2..bw; a step then subtracts the
    distance-1 term, which alone waits for the step before, and the ready
    terms in the order of their distance. That is the order of
    :func:`banded_solve`, so with ``thirds=False`` the two agree bitwise;
    with ``thirds`` every 21-long row sum is taken in three partial sums as
    the kernel takes it."""
    N = r.shape[1]
    bw = Lsub.shape[2]
    mv = _mv_thirds if thirds else _mv

    def sweep(rhs, forward):
        mul = mv if forward else (lambda M, v: mv(M.transpose(-1, -2), v))
        out = [None] * N
        ahead = {}  # (d, node) -> the term of distance d that node will subtract
        for t in range(N):
            k = t if forward else N - 1 - t
            acc = rhs[k]
            if t >= 1:
                prev = k - 1 if forward else k + 1
                acc = acc - mul(Lsub[:, min(k, prev), 0], out[prev])
            for d in range(2, min(bw, t) + 1):
                acc = acc - ahead.pop((d, k))
            out[k] = mul(Ldi[:, k], acc)
            for d in range(2, bw + 1):
                if t + d < N:
                    j = k + d if forward else k - d
                    ahead[d, j] = mul(Lsub[:, min(k, j), d - 1], out[k])
        return out

    ys = sweep([r[:, k] for k in range(N)], True)
    return torch.stack(sweep(ys, False), dim=1)


def factor_banded(Mband, p_col, m_pp, bw: int):
    """Block-banded Cholesky + rank-1 arrow Schur complement (the plain
    version of kernel 2), with the diagonal jitter retry for problems whose
    factorization broke down. The retry runs for the whole batch whether or
    not a problem broke down, in one batch of 2B with the first pass, and its
    factors are taken under the mask of those that did: the same result as a
    retry on demand, with no host synchronisation (so a CUDA graph can
    capture it) and the launches of one pass.

    Returns {"Ldi", "Lsub", "u" (B, N, blk), "s" (B,), "ok" (B,)}. ``ok`` is
    kernel 2's flag on the un-jittered factorization: every pivot above
    1e-20, s above 1e-20, and no factor entry at or above 0.99e8."""
    B = Mband.shape[0]
    jittered = Mband.clone()
    jittered[:, :, 0].diagonal(dim1=-2, dim2=-1).mul_(1.0 + 1e-4)
    pc = torch.cat([p_col, p_col])
    Ldi, Lsub, chol_ok = banded_cholesky(torch.cat([Mband, jittered]), bw)
    u = banded_solve(Ldi, Lsub, pc)
    both = {"Ldi": Ldi, "Lsub": Lsub, "u": u,
            "s": torch.cat([m_pp, m_pp]) - (u * pc).sum(dim=(1, 2))}
    fac, fac2 = ({k: v[half] for k, v in both.items()} for half in (slice(0, B), slice(B, None)))
    chol_ok = chol_ok[:B]
    finite = (
        torch.isfinite(fac["Ldi"]).all(dim=(1, 2, 3)) & torch.isfinite(fac["s"]) & chol_ok
    )
    sat = torch.stack([
        fac["Ldi"].abs().amax(dim=(1, 2, 3)),
        fac["Lsub"].abs().amax(dim=(1, 2, 3, 4)),
        fac["u"].abs().amax(dim=(1, 2)),
        fac["s"].abs(),
    ]).amax(0)
    ok = finite & (fac["s"] > _PIV_FLOOR) & (sat < _SAT)
    fac = {
        k: torch.where(finite.reshape(-1, *([1] * (a.ndim - 1))), a, fac2[k])
        for k, a in fac.items()
    }
    fac["ok"] = ok
    return fac


def factor_banded_ring(Mband, p_col, m_pp, bw: int, ring: str = "shared", staged: int = 4):
    """:func:`factor_banded` without the jitter retry, in kernel 2's
    schedule, for tests: a ring that holds the sub-diagonal blocks of the
    last ``bw`` nodes only (``ring="device"``: no ring, each block read back
    where node j's step wrote it out); per node (A) the Cholesky and inverse
    of S while node k+1's products with nodes before k and the arrow
    column's forward-substitution sum are formed, (B) the products with
    ``Ldi[k]'`` and ``ys[k]``, each block written out and scanned for
    saturation as it becomes final, (C) node k+1's products with node k;
    then the backward sweep from the written factors, ``staged`` nodes
    staged at a time (kernel 2's CH). Every block subtracts its products in
    :func:`banded_cholesky`'s order, so both rings and every ``staged``
    give the same factors."""
    if ring not in ("shared", "device") or staged < 1:
        raise ValueError(f"ring {ring!r}, staged {staged}: expected 'shared' or 'device', >= 1")
    B, N, _, blk, _ = Mband.shape
    T = lambda M: M.transpose(-1, -2)
    eye = torch.eye(blk, dtype=Mband.dtype, device=Mband.device).expand(B, blk, blk)
    shared = {}  # (j % bw, d - 1) -> L[j+d, j] of the last bw nodes j
    if ring == "shared":
        L = lambda i, j: shared[j % bw, i - j - 1]
    else:
        L = lambda i, j: Lsub_out[j][:, i - j - 1]
    Ldi_out, Lsub_out, ys = [], [], []
    chol_ok = torch.ones(B, dtype=torch.bool, device=Mband.device)
    sat = Mband.new_zeros(B)
    S = Mband[:, 0, 0]
    C = {d: Mband[:, 0, d] for d in range(1, bw + 1)}  # M[k+d,k] less its band products
    for k in range(N):
        # (A) factor S; meanwhile what needs no L[., k]
        Lkk, info = torch.linalg.cholesky_ex(S)
        piv = torch.diagonal(Lkk, dim1=-2, dim2=-1)
        chol_ok &= (info == 0) & ((piv * piv).amin(-1) > _PIV_FLOOR)
        Linv = torch.linalg.solve_triangular(Lkk, eye, upper=False)
        acc = p_col[:, k]
        for d in range(1, min(bw, k) + 1):
            acc = acc - _mv(L(k, k - d), ys[k - d])
        if k + 1 < N:
            S = Mband[:, k + 1, 0]
            for j in range(max(0, k + 1 - bw), k):
                S = S - L(k + 1, j) @ T(L(k + 1, j))
            nxt = {d: Mband[:, k + 1, d] for d in range(1, bw + 1) if k + 1 + d < N}
            for d in nxt:
                for j in range(max(0, k + 1 + d - bw), k):
                    nxt[d] = nxt[d] - L(k + 1 + d, j) @ T(L(k + 1, j))
        # (B) the node's blocks become final and leave
        final = [C[d] @ T(Linv) if k + d < N else torch.zeros_like(Linv)
                 for d in range(1, bw + 1)]
        if ring == "shared":
            shared.update({(k % bw, d): final[d] for d in range(bw)})
        written = torch.stack(final, dim=1)
        Ldi_out.append(Linv)
        Lsub_out.append(written)
        sat = torch.maximum(sat, torch.maximum(Linv.abs().amax(dim=(1, 2)),
                                               written.abs().amax(dim=(1, 2, 3))))
        ys.append(_mv(Linv, acc))
        # (C) node k+1's products with node k
        if k + 1 < N:
            S = S - L(k + 1, k) @ T(L(k + 1, k))
            C = {d: nxt[d] - L(k + 1 + d, k) @ T(L(k + 1, k)) if d < bw else nxt[d] for d in nxt}
    Ldi, Lsub = torch.stack(Ldi_out, dim=1), torch.stack(Lsub_out, dim=1)
    xs = [None] * N
    for top in range(N - 1, -1, -staged):  # from the written factors, newest first
        stage = {k: (Ldi[:, k], Lsub[:, k]) for k in range(top, max(top - staged, -1), -1)}
        for k, (ldi, lsub) in stage.items():
            acc = ys[k]
            for d in range(1, min(bw, N - 1 - k) + 1):
                acc = acc - _mtv(lsub[:, d - 1], xs[k + d])
            xs[k] = _mtv(ldi, acc)
    u = torch.stack(xs, dim=1)
    s = m_pp - (u * p_col).sum(dim=(1, 2))
    sat = torch.maximum(sat, torch.maximum(u.abs().amax(dim=(1, 2)), s.abs()))
    finite = torch.isfinite(Ldi).all(dim=(1, 2, 3)) & torch.isfinite(s) & chol_ok
    return {"Ldi": Ldi, "Lsub": Lsub, "u": u, "s": s,
            "ok": finite & (s > _PIV_FLOOR) & (sat < _SAT)}


def solve_arrow_banded(ocp, fac, rhs, solve=banded_solve):
    """Solve M x = rhs (z-layout) with the banded + arrow factors;
    ``solve`` is :func:`banded_solve` or :func:`banded_solve_lookahead`."""
    r_b, r_p = split_node_major(ocp, rhs)
    t = solve(fac["Ldi"], fac["Lsub"], r_b)
    z_p = (r_p - (fac["u"] * r_b).sum(dim=(1, 2))) / fac["s"]
    z_b = t - fac["u"] * z_p[:, None, None]
    return join_node_major(ocp, z_b, z_p)


# ---------------------------------------------------------------------------
# The group block-tridiagonal form (a reference form; no solve path uses it)
# ---------------------------------------------------------------------------
#
# The JAX package's portable path factors the band over groups of three
# nodes as a block-tridiagonal matrix with dense (63 x 63) diagonal
# inverses. The port solves through the node-level factor everywhere (the
# form of kernels 2 and 3); this form is kept for parity with the JAX
# functions at float64. At float32 the JAX form stops short on a few QPs
# that the node-level factor converges (ROADMAP Queue 3).

_GROUP = 3  # nodes per tridiagonal group (at least the band width)


def _tri_lower_inv(L):
    """Batched inverse of lower-triangular (..., blk, blk)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _to_group_tridiag(Mband, bw: int):
    """The node-level band as a block-tridiagonal matrix over groups of
    ``_GROUP`` nodes: (diag (B, G, gb, gb), sub (B, G-1, gb, gb)) with
    identity padding nodes at the end; the d > 0 node blocks inside a group
    are mirrored into its upper triangle."""
    B, N, _, blk, _ = Mband.shape
    G = -(-N // _GROUP)
    gb = _GROUP * blk
    diag = Mband.new_zeros(B, G, gb, gb)
    sub = Mband.new_zeros(B, G - 1, gb, gb)
    for k in range(N):
        gc, lc = divmod(k, _GROUP)
        for d in range(bw + 1):
            if k + d >= N:
                continue
            gr, lr = divmod(k + d, _GROUP)
            blkv = Mband[:, k, d]
            r0, c0 = lr * blk, lc * blk
            if gr == gc:
                diag[:, gc, r0:r0 + blk, c0:c0 + blk] += blkv
                if d > 0:
                    diag[:, gc, c0:c0 + blk, r0:r0 + blk] += blkv.transpose(-1, -2)
            else:  # gr == gc + 1 (bw <= _GROUP)
                sub[:, gc, r0:r0 + blk, c0:c0 + blk] += blkv
    for k in range(N, G * _GROUP):
        gc, lc = divmod(k, _GROUP)
        r0 = lc * blk
        diag[:, gc, r0:r0 + blk, r0:r0 + blk] += torch.eye(blk, dtype=Mband.dtype,
                                                           device=Mband.device)
    return diag, sub


def _tridiag_cholesky(diag, sub):
    """Batched block-tridiagonal Cholesky M = L L'. Returns (Ld_inv
    (B, G, gb, gb) inverses of the diagonal factors, Lc (B, G-1, gb, gb)
    = L[g+1, g]). A factorization that breaks down gives NaN, as the JAX
    Cholesky does."""
    G = diag.shape[1]
    Ld_inv, Lc = [], []
    S = diag[:, 0]
    for g in range(G):
        Lgg, info = torch.linalg.cholesky_ex(S)
        Lgg = torch.where((info == 0)[:, None, None], Lgg, torch.full_like(Lgg, float("nan")))
        Linv = _tri_lower_inv(Lgg)
        Ld_inv.append(Linv)
        if g < G - 1:
            C = sub[:, g] @ Linv.transpose(-1, -2)  # L[g+1, g]
            Lc.append(C)
            S = diag[:, g + 1] - C @ C.transpose(-1, -2)
    return torch.stack(Ld_inv, 1), torch.stack(Lc, 1)


def _tridiag_solve(Ld_inv, Lc, r):
    """Solve (L L') x = r for group-major r (B, G, gb)."""
    G = Ld_inv.shape[1]
    ys = []
    for g in range(G):
        acc = r[:, g]
        if g > 0:
            acc = acc - _mv(Lc[:, g - 1], ys[g - 1])
        ys.append(_mv(Ld_inv[:, g], acc))
    xs = [None] * G
    for g in range(G - 1, -1, -1):
        acc = ys[g]
        if g < G - 1:
            acc = acc - _mtv(Lc[:, g], xs[g + 1])
        xs[g] = _mtv(Ld_inv[:, g], acc)
    return torch.stack(xs, dim=1)


def _pad_groups(r_nodes, G: int):
    """(B, N, blk) node-major -> (B, G, _GROUP * blk) group-major, padded."""
    B, N, blk = r_nodes.shape
    r_nodes = torch.nn.functional.pad(r_nodes, (0, 0, 0, G * _GROUP - N))
    return r_nodes.reshape(B, G, _GROUP * blk)


def factor_arrow(Mband, p_col, m_pp, bw: int):
    """Factor the banded + arrow system in the group block-tridiagonal form
    with the rank-1 Schur complement of the time parameter. Returns
    {"Ld_inv", "Lc", "u" (B, G, gb), "s" (B,)} for :func:`solve_arrow`.
    Problems whose factors are not finite take those of the band with its
    diagonal scaled by 1 + 1e-4, under the mask, as :func:`factor_banded`
    does."""
    blk = Mband.shape[-1]

    def run(Mb):
        Ld_inv, Lc = _tridiag_cholesky(*_to_group_tridiag(Mb, bw))
        pc = _pad_groups(p_col, Ld_inv.shape[1])
        u = _tridiag_solve(Ld_inv, Lc, pc)
        return {"Ld_inv": Ld_inv, "Lc": Lc, "u": u, "s": m_pp - (u * pc).sum(dim=(1, 2))}

    fac = run(Mband)
    finite = torch.isfinite(fac["Ld_inv"]).all(dim=(1, 2, 3)) & torch.isfinite(fac["s"])
    Mb = Mband.clone()
    dg = torch.arange(blk, device=Mband.device)
    Mb[:, :, 0, dg, dg] *= 1.0 + 1e-4
    fac2 = run(Mb)
    return {k: torch.where(finite.reshape(-1, *([1] * (a.ndim - 1))), a, fac2[k])
            for k, a in fac.items()}


def solve_arrow(ocp, fac, bw: int, rhs):
    """Solve M x = rhs (z-layout (B, n)) with :func:`factor_arrow`'s
    factors."""
    r_b, r_p = split_node_major(ocp, rhs)
    B, N, blk = r_b.shape
    G = fac["Ld_inv"].shape[1]
    rg = _pad_groups(r_b, G)
    t = _tridiag_solve(fac["Ld_inv"], fac["Lc"], rg)
    z_p = (r_p - (fac["u"] * rg).sum(dim=(1, 2))) / fac["s"]
    z_b = (t - fac["u"] * z_p[:, None, None]).reshape(B, G * _GROUP, blk)[:, :N]
    return join_node_major(ocp, z_b, z_p)


# ---------------------------------------------------------------------------
# Problem scaling shared by the plain loop and kernel 3's host part
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScaledQP:
    """Ruiz-scaled problem data, ADMM weights and initial iterates.

    z-layout (B, n): D, Ps, qs, lxs, uxs, pat_x, soft_xs, rx, thx, x, zx, yx.
    m-layout (B, m): E, lcs, ucs, pat_c, soft_s, rc, thr, zc, yc.
    Per problem (B,): rho. Banded KKT system: Mband, p_col, m_pp.
    What depends on rho (rc, rx, thr, thx and the KKT system) is rebuilt by
    :func:`with_rho`."""

    D: torch.Tensor
    E: torch.Tensor
    Ps: torch.Tensor
    qs: torch.Tensor
    lcs: torch.Tensor
    ucs: torch.Tensor
    lxs: torch.Tensor
    uxs: torch.Tensor
    pat_c: torch.Tensor
    pat_x: torch.Tensor
    soft_s: torch.Tensor
    soft_xs: torch.Tensor
    rho: torch.Tensor
    rc: torch.Tensor
    rx: torch.Tensor
    thr: torch.Tensor
    thx: torch.Tensor
    Mband: torch.Tensor
    p_col: torch.Tensor
    m_pp: torch.Tensor
    x: torch.Tensor
    zc: torch.Tensor
    zx: torch.Tensor
    yc: torch.Tensor
    yx: torch.Tensor


def _rho_dependent(ocp, sa, D, E, Ps, pat_c, pat_x, soft_s, soft_xs, rho, sigma):
    """The ADMM weights, soft thresholds and banded KKT system of a
    per-problem rho (B,), as ScaledQP fields."""
    B = rho.shape[0]
    K, nx, nodes = ocp.coll.order + 1, ocp.nx, ocp.num_nodes
    rc = rho[:, None] * pat_c
    rx = rho[:, None] * pat_x
    # cap the numerator before the divide so hard rows give exactly _HARD
    thr = torch.minimum(soft_s, _HARD * rc) / rc
    thx = torch.minimum(soft_xs, _HARD * rx) / rx
    w = E * E * rc
    Mband, p_col, m_pp = assemble_banded_M(
        ocp, sa,
        w[:, : ocp.num_eq].reshape(B, -1, K, nx),
        w[:, ocp.num_eq :].reshape(B, nodes, -1),
        D, Ps + sigma + rx,
    )
    return dict(rho=rho, rc=rc, rx=rx, thr=thr, thx=thx, Mband=Mband, p_col=p_col, m_pp=m_pp)


def with_rho(ocp, sa, qp: ScaledQP, rho, settings: QPSettings) -> ScaledQP:
    """``qp`` at another per-problem rho (B,): the scaling, bounds and
    iterates stay, everything that depends on rho is rebuilt."""
    return dataclasses.replace(qp, **_rho_dependent(
        ocp, sa, qp.D, qp.E, qp.Ps, qp.pat_c, qp.pat_x, qp.soft_s, qp.soft_xs, rho,
        settings.sigma))


def scale_qp(ocp, sa, P_diag, q, lc, uc, lx, ux, settings: QPSettings,
             x0=None, yc0=None, yx0=None, soft_c=None, soft_x=None) -> ScaledQP:
    """Ruiz scaling, ±1e20 stand-ins for infinite bounds, soft-row
    thresholds, the banded KKT assembly at ``settings.rho`` and the scaled
    initial iterates — in the dtype of ``q``."""
    B, n = q.shape
    m = lc.shape[1]
    dt, dev = q.dtype, q.device

    if settings.ruiz_iters > 0:
        D, E = ruiz_structured(ocp, sa, settings.ruiz_iters)
    else:
        D = torch.ones(B, n, dtype=dt, device=dev)
        E = torch.ones(B, m, dtype=dt, device=dev)

    Ps = D * P_diag * D
    qs = D * q
    finite = lambda a: torch.clamp(a, -_HARD, _HARD)
    lcs, ucs = finite(E * lc), finite(E * uc)
    lxs, uxs = finite(lx / D), finite(ux / D)

    pat_c = _rho_pattern(lc, uc, settings)
    pat_x = _rho_pattern(lx, ux, settings)
    hard_m = torch.full((B, m), _HARD, dtype=dt, device=dev)
    hard_n = torch.full((B, n), _HARD, dtype=dt, device=dev)
    soft_s = hard_m if soft_c is None else torch.where(soft_c > 0, soft_c / E, hard_m)
    soft_xs = hard_n if soft_x is None else torch.where(soft_x > 0, soft_x * D, hard_n)
    rho = torch.full((B,), settings.rho, dtype=dt, device=dev)

    x = torch.zeros(B, n, dtype=dt, device=dev) if x0 is None else x0 / D
    yc = torch.zeros(B, m, dtype=dt, device=dev) if yc0 is None else yc0 / E
    yx = torch.zeros(B, n, dtype=dt, device=dev) if yx0 is None else yx0 * D
    zc = torch.clamp(E * apply_A(ocp, sa, D * x), lcs, ucs)
    zx = torch.clamp(x, lxs, uxs)
    return ScaledQP(
        D=D, E=E, Ps=Ps, qs=qs, lcs=lcs, ucs=ucs, lxs=lxs, uxs=uxs, pat_c=pat_c,
        pat_x=pat_x, soft_s=soft_s, soft_xs=soft_xs, x=x, zc=zc, zx=zx, yc=yc, yx=yx,
        **_rho_dependent(ocp, sa, D, E, Ps, pat_c, pat_x, soft_s, soft_xs, rho,
                         settings.sigma),
    )


def unscale_solution(qp: ScaledQP, x, zc, zx, yc, yx, done, iters, rp, rd) -> QPSolution:
    """QP solution from the scaled ADMM state (as the loops return it)."""
    return QPSolution(
        x=qp.D * x,
        y_constraints=qp.E * yc,
        y_box=yx / qp.D,
        converged=done == 1,
        iterations=iters,
        prim_residual=rp,
        dual_residual=rd,
    )


# ---------------------------------------------------------------------------
# The plain structured ADMM loop (kernel 3's plain version)
# ---------------------------------------------------------------------------


def _ftz(v):
    v = torch.where(v.abs() < 1e-30, torch.zeros_like(v), v)
    return torch.clamp(v, -1e15, 1e15)


def _soft_update(za, y, r, lo, hi, t):
    return _ftz(_soft_prox(za + y / r, lo, hi, t))


def _residual_terms(ocp, sa, qp: ScaledQP, x, zc, zx, yc, yx):
    """OSQP primal and dual residuals and their scales, in unscaled units:
    (r_prim, r_dual, scale_p, scale_d), each (B,)."""
    D, E = qp.D, qp.E
    amax = lambda a: a.abs().amax(dim=-1)
    Ax = E * apply_A(ocp, sa, D * x)
    r_prim = torch.maximum(amax((Ax - zc) / E), amax(D * (x - zx)))
    Aty = D * apply_AT(ocp, sa, E * yc)
    r_dual = amax((qp.Ps * x + qp.qs + Aty + yx) / D)
    scale_p = torch.maximum(
        torch.maximum(amax(Ax / E), amax(zc / E)),
        torch.maximum(amax(D * x), amax(D * zx)),
    )
    scale_d = torch.maximum(
        torch.maximum(amax(qp.Ps * x / D), amax(qp.qs / D)),
        torch.maximum(amax(Aty / D), amax(yx / D)),
    )
    return r_prim, r_dual, scale_p, scale_d


def admm_residuals(ocp, sa, qp: ScaledQP, settings, x, zc, zx, yc, yx):
    """OSQP-style residuals and the convergence flag, per problem."""
    r_prim, r_dual, scale_p, scale_d = _residual_terms(ocp, sa, qp, x, zc, zx, yc, yx)
    eps_p = settings.eps_abs + settings.eps_rel * scale_p
    eps_d = settings.eps_abs + settings.eps_rel * scale_d
    return (r_prim <= eps_p) & (r_dual <= eps_d), r_prim, r_dual


def residual_ratio(ocp, sa, qp: ScaledQP, x, zc, zx, yc, yx):
    """sqrt of the scaled primal over the scaled dual residual, per problem:
    the factor by which the rho update rescales rho."""
    r_prim, r_dual, scale_p, scale_d = _residual_terms(ocp, sa, qp, x, zc, zx, yc, yx)
    floor = lambda a: torch.clamp(a, min=1e-12)
    return torch.sqrt((r_prim / floor(scale_p)) / floor(r_dual / floor(scale_d)))


def initial_state(qp: ScaledQP):
    """The ADMM state before the first iteration: the scaled iterates of
    ``qp``, no problem done, no iteration counted, residuals 0."""
    B, dev = qp.x.shape[0], qp.x.device
    zeros = lambda dtype: torch.zeros(B, dtype=dtype, device=dev)
    return (qp.x, qp.zc, qp.zx, qp.yc, qp.yx, zeros(torch.int32), zeros(torch.int32),
            zeros(qp.x.dtype), zeros(qp.x.dtype))


def admm_plain(ocp, sa, qp: ScaledQP, fac, settings: QPSettings, state=None,
               chunk_iters=None):
    """One dispatch of the ADMM loop with kernel 3's semantics, rho fixed:
    ``chunk_iters`` iterations (default: the whole budget, ``max_iter +
    rescue_iters``) from ``state`` (default: :func:`initial_state`), with
    the residual check every ``check_every`` iterations of the dispatch and
    at its last. A problem whose ``done`` is set on entry is left as it is;
    ``iters`` adds the dispatch's active iterations, and ``rp``/``rd`` change
    only for problems active in it. Takes and returns the scaled (x, zc, zx,
    yc, yx, done (int32), iters (int32), rp, rd). The dispatch runs in check
    windows (:func:`admm_window`), and it ends early once every problem is
    done."""
    cap = settings.max_iter + settings.rescue_iters if chunk_iters is None else chunk_iters
    state = initial_state(qp) if state is None else state
    for first, last in check_windows(settings, cap):
        if bool((state[5] != 0).all()):
            break
        state = admm_window(ocp, sa, qp, fac, settings, state, first, last, cap)
    return state


def check_windows(settings: QPSettings, cap: int):
    """The check windows of a dispatch of ``cap`` iterations: (first, last)
    iteration of each, the last one checked (every ``check_every`` and the
    dispatch's last)."""
    ce = settings.check_every
    return [(k, min(k + ce - 1, cap)) for k in range(1, cap + 1, ce)]


def admm_window(ocp, sa, qp: ScaledQP, fac, settings: QPSettings, state, first: int, last: int,
                cap: int):
    """Iterations ``first`` to ``last`` of a dispatch of ``cap`` (see
    :func:`admm_plain`), with no host synchronisation, so that a window can
    be captured into a CUDA graph: the residual check runs at each of them
    that is a multiple of ``check_every`` or the dispatch's last."""
    D, E = qp.D, qp.E
    alpha, sigma = settings.alpha, settings.sigma
    x, zc, zx, yc, yx, done, iters, rp, rd = state
    matA = lambda v: E * apply_A(ocp, sa, D * v)
    matAT = lambda w: D * apply_AT(ocp, sa, E * w)
    sig = qp.Ps + sigma + qp.rx

    for k in range(first, last + 1):
        rhs = sigma * x - qp.qs + qp.rx * zx - yx + matAT(qp.rc * zc - yc)
        xt = solve_arrow_banded(ocp, fac, rhs)
        for _ in range(settings.kkt_refine):
            Mxt = sig * xt + matAT(qp.rc * matA(xt))
            xt = xt + solve_arrow_banded(ocp, fac, rhs - Mxt)
        zt_c = matA(xt)

        x_new = _ftz(alpha * xt + (1 - alpha) * x)
        zc_arg = alpha * zt_c + (1 - alpha) * zc
        zc_new = _soft_update(zc_arg, yc, qp.rc, qp.lcs, qp.ucs, qp.thr)
        yc_new = _ftz(yc + qp.rc * (zc_arg - zc_new))
        zx_arg = alpha * xt + (1 - alpha) * zx
        zx_new = _soft_update(zx_arg, yx, qp.rx, qp.lxs, qp.uxs, qp.thx)
        yx_new = _ftz(yx + qp.rx * (zx_arg - zx_new))

        active = done == 0
        a = active[:, None]
        x = torch.where(a, x_new, x)
        zc = torch.where(a, zc_new, zc)
        zx = torch.where(a, zx_new, zx)
        yc = torch.where(a, yc_new, yc)
        yx = torch.where(a, yx_new, yx)
        iters = iters + active.to(torch.int32)

        if k % settings.check_every == 0 or k >= cap:
            mag = torch.stack(
                [x.abs().amax(-1), yc.abs().amax(-1), yx.abs().amax(-1)]
            ).amax(0)
            big = ~(mag <= _BIG)
            conv, rp_new, rd_new = admm_residuals(ocp, sa, qp, settings, x, zc, zx, yc, yx)
            rp = torch.where(active, rp_new, rp)
            rd = torch.where(active, rd_new, rd)
            done = torch.where(
                active & big, torch.full_like(done, 2),
                torch.where(active & conv, torch.ones_like(done), done),
            )
    return x, zc, zx, yc, yx, done, iters, rp, rd


def chunk_sizes(settings: QPSettings):
    """Iterations per dispatch: the whole budget ``max_iter + rescue_iters``
    in one when rho is fixed, else in chunks of ``rho_update_every`` (the
    last one shorter where it does not divide the budget)."""
    cap = settings.max_iter + settings.rescue_iters
    every = settings.rho_update_every
    if every <= 0:
        return [cap]
    return [min(every, cap - c) for c in range(0, cap, every)]


def admm_chunked(ocp, sa, qp: ScaledQP, settings: QPSettings, factor, admm):
    """The ADMM loop as the fused kernel's host part runs it: one dispatch
    of ``admm`` per entry of :func:`chunk_sizes` on the factors of
    ``factor(Mband, p_col, m_pp, bw)``, and between two dispatches the
    OSQP rho update: a problem that is not done and whose residual ratio is
    above 5 or below 0.2 gets ``rho = clip(rho * ratio, rho_min, rho_max)``.
    At every boundary everything that depends on rho is rebuilt
    (:func:`with_rho`) and refactored for the batch under that per-problem
    mask, with no host synchronisation (so a CUDA graph can capture the
    loop): where no problem wants another rho the rebuilt band and its
    factor are bitwise the ones before. ``admm`` is :func:`admm_plain` or
    kernel 3's wrapper, ``factor`` :func:`factor_banded` or kernel 2's.

    Returns (state as :func:`admm_plain` returns it, the final ScaledQP,
    whose ``rho`` is each problem's last rho, and the number of boundaries
    at which some problem's rho moved, a 0-d int64 tensor on the device)."""
    bw = ocp.coll.order
    fac = factor(qp.Mband, qp.p_col, qp.m_pp, bw)
    sizes = chunk_sizes(settings)
    state = initial_state(qp)
    refactors = torch.zeros((), dtype=torch.int64, device=qp.x.device)
    for c, chunk_iters in enumerate(sizes):
        state = admm(ocp, sa, qp, fac, settings, state, chunk_iters)
        if c == len(sizes) - 1:
            break
        ratio = residual_ratio(ocp, sa, qp, *state[:5])
        want = (state[5] == 0) & ((ratio > 5.0) | (ratio < 0.2))
        rho = torch.where(
            want, torch.clamp(qp.rho * ratio, settings.rho_min, settings.rho_max), qp.rho)
        qp = with_rho(ocp, sa, qp, rho, settings)
        fac = factor(qp.Mband, qp.p_col, qp.m_pp, bw)
        refactors = refactors + want.any()
    return state, qp, refactors


def solve_box_qp_structured(
    ocp, sa: StructuredA, P_diag, q, lc, uc, lx, ux,
    settings: QPSettings = QPSettings(),
    x0=None, yc0=None, yx0=None, soft_c=None, soft_x=None,
) -> QPSolution:
    """The plain structured QP solve in the caller's dtype (kernel 2 and 3's
    plain versions end to end). P must be diagonal (B, n)."""
    settings.check_structured()
    qp = scale_qp(ocp, sa, P_diag, q, lc, uc, lx, ux, settings, x0, yc0, yx0,
                  soft_c, soft_x)
    state, qp, _ = admm_chunked(ocp, sa, qp, settings, factor_banded, admm_plain)
    return unscale_solution(qp, *state)
