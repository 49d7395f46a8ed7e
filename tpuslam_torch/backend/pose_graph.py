"""Pose-graph optimisation: fold loop-closure constraints into the trajectory.

Port of ``tpuslam/backend/pose_graph.py``.  Gauss-Newton over SE(3) nodes
(cam-to-world ``T_i``) with fixed-capacity edge buffers; the residual of
edge i → j with measurement T̂_ij is r = log(T̂_ij⁻¹ · T_i⁻¹ · T_j) ∈ se(3)
under the left update T ← exp(δ)·T, and node 0 is the gauge anchor.  The
edge Jacobians come from ``torch.func.jacfwd`` of that residual at δ = 0,
vmapped over the edges (the reference's ``jax.jacfwd``).

Two linear solvers behind one GN loop: ``"dense"`` assembles H as
(N, 6, N, 6) and solves the (6N, 6N) system (the default for N ≤ 256);
``"pcg"`` is matrix-free block-Jacobi preconditioned CG over the (E, 6, 6)
edge blocks, with the reference's early exit once the preconditioned
residual falls 1e-10 below its start.  The CG loop runs on the device in
blocks of ``CG_BLOCK`` steps, each step masked once converged (the
``while_loop``'s semantics), with one host read of the flag a block.
Every computation follows the nodes' dtype (float32 or float64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from tpuslam_torch.common.geometry import pose_matrix, so3_exp, so3_log

CG_BLOCK = 16  # CG steps between host reads of the convergence flag


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph."""

    nodes: torch.Tensor  # (N, 4, 4) — T_world_cam per node
    node_valid: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_T: torch.Tensor  # (E, 4, 4) — measured T_i⁻¹ T_j
    edge_weight: torch.Tensor  # (E,) (0 = inactive)


def empty_graph(max_nodes: int, max_edges: int, device: torch.device | str = "cpu") -> PoseGraph:
    eye = torch.eye(4, device=device)
    return PoseGraph(
        nodes=eye.expand(max_nodes, 4, 4).clone(),
        node_valid=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        edge_i=torch.zeros(max_edges, dtype=torch.int64, device=device),
        edge_j=torch.zeros(max_edges, dtype=torch.int64, device=device),
        edge_T=eye.expand(max_edges, 4, 4).clone(),
        edge_weight=torch.zeros(max_edges, device=device),
    )


def _se3_log(T: torch.Tensor) -> torch.Tensor:
    """(…, 4, 4) → (…, 6) (ω, ν), first order (ν = the translation): enough near the identity."""
    return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def _apply_delta(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update T ← exp(δ)·T."""
    dR = so3_exp(delta[..., :3])
    R = dR @ T[..., :3, :3]
    t = (dR @ T[..., :3, 3:4])[..., 0] + delta[..., 3:]
    return pose_matrix(R, t)


def _edge_residual(delta_i, delta_j, Ti, Tj, T_meas_inv):
    """One edge's residual log(T̂⁻¹ · T_i'⁻¹ · T_j') after the updates δ_i, δ_j."""
    Ti_new = _apply_delta(Ti, delta_i)
    Tj_new = _apply_delta(Tj, delta_j)
    RiT = Ti_new[:3, :3].T
    rel = pose_matrix(RiT @ Tj_new[:3, :3], RiT @ (Tj_new[:3, 3] - Ti_new[:3, 3]))
    return _se3_log(T_meas_inv @ rel)


_edge_jacobians = vmap(jacfwd(_edge_residual, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0))
_edge_residuals = vmap(_edge_residual, in_dims=(None, None, 0, 0, 0))


def edge_blocks(g: PoseGraph, nodes: torch.Tensor, T_meas_inv: torch.Tensor):
    """(J_i (E, 6, 6), J_j (E, 6, 6), r (E, 6)) at δ = 0."""
    zero6 = torch.zeros(6, dtype=nodes.dtype, device=nodes.device)
    Ti, Tj = nodes[g.edge_i], nodes[g.edge_j]
    Ji, Jj = _edge_jacobians(zero6, zero6, Ti, Tj, T_meas_inv)
    # forward-mode AD promotes tangents of 0-dim scalar arithmetic to float64: back to the nodes' dtype
    return Ji.to(nodes.dtype), Jj.to(nodes.dtype), _edge_residuals(zero6, zero6, Ti, Tj, T_meas_inv)


def _blocks(Ja: torch.Tensor, w: torch.Tensor, Jb: torch.Tensor) -> torch.Tensor:
    return torch.einsum("eri,e,erj->eij", Ja, w, Jb)


def _rhs(Ji, Jj, w, r):
    return -torch.einsum("eri,e,er->ei", Ji, w, r), -torch.einsum("eri,e,er->ei", Jj, w, r)


def _gn_step_dense(g: PoseGraph, nodes, T_meas_inv, free, damping):
    N = nodes.shape[0]
    Ji, Jj, r = edge_blocks(g, nodes, T_meas_inv)
    w = g.edge_weight.to(nodes.dtype)
    H = torch.zeros((N, N, 6, 6), dtype=nodes.dtype, device=nodes.device)
    for a, b, Ja, Jb in ((g.edge_i, g.edge_i, Ji, Ji), (g.edge_j, g.edge_j, Jj, Jj),
                         (g.edge_i, g.edge_j, Ji, Jj), (g.edge_j, g.edge_i, Jj, Ji)):
        H.index_put_((a, b), _blocks(Ja, w, Jb), accumulate=True)
    bi, bj = _rhs(Ji, Jj, w, r)
    rhs = torch.zeros((N, 6), dtype=nodes.dtype, device=nodes.device)
    rhs.index_put_((g.edge_i,), bi, accumulate=True)
    rhs.index_put_((g.edge_j,), bj, accumulate=True)
    # gauge and inactive nodes: their rows and columns zeroed, identity diagonal
    H = H * free[:, None, None, None] * free[None, :, None, None]
    eye6 = torch.eye(6, dtype=nodes.dtype, device=nodes.device)
    diag = torch.arange(N, device=nodes.device)
    H[diag, diag] += ((1.0 - free) + damping)[:, None, None] * eye6
    rhs = rhs * free[:, None]
    Hm = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    delta = torch.linalg.solve_ex(Hm, rhs.reshape(-1, 1), check_errors=False)[0].reshape(N, 6)
    return _apply_delta(nodes, delta * free[:, None])


def _gn_step_pcg(g: PoseGraph, nodes, T_meas_inv, free, damping, Si, Sj, cg_iterations):
    N = nodes.shape[0]
    Ji, Jj, r = edge_blocks(g, nodes, T_meas_inv)
    w = g.edge_weight.to(nodes.dtype)
    Aii, Ajj, Aij = _blocks(Ji, w, Ji), _blocks(Jj, w, Jj), _blocks(Ji, w, Jj)
    bi, bj = _rhs(Ji, Jj, w, r)
    b = (Si @ bi + Sj @ bj) * free[:, None]  # (N, 6): one-hot accumulation, as the reference
    fixed = ((1.0 - free) + damping)[:, None]

    def hv(v):
        """H·v with the dense path's gauge and damping."""
        ve = v * free[:, None]
        vi, vj = ve[g.edge_i], ve[g.edge_j]
        yi = torch.einsum("eij,ej->ei", Aii, vi) + torch.einsum("eij,ej->ei", Aij, vj)
        yj = torch.einsum("eji,ej->ei", Aij, vi) + torch.einsum("eij,ej->ei", Ajj, vj)
        return (Si @ yi + Sj @ yj) * free[:, None] + fixed * v

    eye6 = torch.eye(6, dtype=nodes.dtype, device=nodes.device)
    D = ((Si @ Aii.reshape(-1, 36) + Sj @ Ajj.reshape(-1, 36)).reshape(N, 6, 6) * free[:, None, None]
         + fixed[..., None] * eye6)
    Dinv = torch.linalg.inv_ex(D)[0]

    def precond(v):
        return torch.einsum("nij,nj->ni", Dinv, v)

    x = torch.zeros_like(b)
    res = b
    z = precond(b)
    p = z
    rz = torch.sum(b * z)
    tol = 1e-10 * torch.clamp_min(rz, 1e-30)
    it = 0
    while it < cg_iterations:
        for _ in range(min(CG_BLOCK, cg_iterations - it)):
            active = rz > tol
            Hp = hv(p)
            alpha = rz / torch.clamp_min(torch.sum(p * Hp), 1e-20)
            x = torch.where(active, x + alpha * p, x)
            res_new = res - alpha * Hp
            z = precond(res_new)
            rz_new = torch.sum(res_new * z)
            p = torch.where(active, z + (rz_new / torch.clamp_min(rz, 1e-20)) * p, p)
            res = torch.where(active, res_new, res)
            rz = torch.where(active, rz_new, rz)
            it += 1
        if not bool(rz > tol):  # one host read a block
            break
    delta = x * free[:, None]
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return _apply_delta(nodes, delta)


def optimize_pose_graph(
    g: PoseGraph,
    *,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str | None = None,
    cg_iterations: int | None = None,
) -> PoseGraph:
    """Gauss-Newton over all nodes; node 0 is the gauge anchor (see the module docstring)."""
    N = g.nodes.shape[0]
    if solver is None:
        solver = "dense" if N <= 256 else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iterations is None:
        # CG carries a correction one graph hop a step: a chain needs >= N steps
        cg_iterations = max(4 * N, 200)
    nodes = g.nodes
    T_meas_inv = torch.linalg.inv(g.edge_T)
    free = g.node_valid.to(nodes.dtype).clone()
    free[0] = 0.0
    if solver == "pcg":
        narange = torch.arange(N, device=nodes.device)
        Si = (g.edge_i[None, :] == narange[:, None]).to(nodes.dtype)
        Sj = (g.edge_j[None, :] == narange[:, None]).to(nodes.dtype)
    for _ in range(iterations):
        if solver == "dense":
            nodes = _gn_step_dense(g, nodes, T_meas_inv, free, damping)
        else:
            nodes = _gn_step_pcg(g, nodes, T_meas_inv, free, damping, Si, Sj, cg_iterations)
    return g._replace(nodes=nodes)


def add_edge(g: PoseGraph, slot: int, i: int, j: int, T_rel: torch.Tensor, weight: float = 1.0) -> PoseGraph:
    edge_i, edge_j, edge_T, edge_w = (x.clone() for x in (g.edge_i, g.edge_j, g.edge_T, g.edge_weight))
    edge_i[slot] = i
    edge_j[slot] = j
    edge_T[slot] = torch.as_tensor(T_rel).to(edge_T)
    edge_w[slot] = weight
    return g._replace(edge_i=edge_i, edge_j=edge_j, edge_T=edge_T, edge_weight=edge_w)


def graph_from_trajectory(poses: torch.Tensor, max_edges: int | None = None) -> PoseGraph:
    """A chain graph (float32, as the reference) from (N, 4, 4) cam-to-world poses."""
    N = poses.shape[0]
    E = max_edges if max_edges is not None else 4 * N
    g = empty_graph(N, E, poses.device)
    rel = torch.linalg.inv(poses[:-1]) @ poses[1:]
    idx = torch.arange(N - 1, device=poses.device)
    edge_i, edge_j, edge_T, edge_w = g.edge_i.clone(), g.edge_j.clone(), g.edge_T.clone(), g.edge_weight.clone()
    edge_i[: N - 1] = idx
    edge_j[: N - 1] = idx + 1
    edge_T[: N - 1] = rel.float()
    edge_w[: N - 1] = 1.0
    return g._replace(nodes=poses.float(), node_valid=torch.ones(N, dtype=torch.bool, device=poses.device),
                      edge_i=edge_i, edge_j=edge_j, edge_T=edge_T, edge_weight=edge_w)
