"""The pose graph: tpuslam_torch's against tpuslam's on the CPU.

The reference's drift fixture (``test_pose_graph.py``): a 40-node circle
integrated with a 2% systematic drift, one loop edge 39 ↔ 0 of weight 20
with the true relative transform, 15 Gauss-Newton steps.  Both solvers
(dense and PCG) in float32 and in float64 (the reference under
``jax.enable_x64``), and the edge Jacobians (``torch.func.jacfwd``)
against ``jax.jacfwd`` on random edges.

Finding (tolerances).  In float32 the packages agree to 1.4e-6 (dense) and
9.5e-7 (PCG): held at 1e-5.  In float64 the reference's dense step
allocates H and b as float32 (``jnp.zeros(..., jnp.float32)``), so its
"float64" linear solve is a float32 one: 2.6e-7 apart, held at 1e-6.  Its
PCG step runs in float64 but stops at a preconditioned residual 1e-10
below its start (or after 200 steps), which leaves one GN step's CG
solution far from exact on this chain and sensitive to rounding (after one
GN step the packages are 2.4e-4 apart); after 15 both end at stationary
points (gradient below 1e-8, held) 4.4e-8 apart (the port on one
thread): held at 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pose_graph import circle_trajectory, drifted_trajectory
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend import pose_graph as jpg
from tpuslam_torch.backend import pose_graph as tpg

TOL = {("dense", False): 1e-5, ("pcg", False): 1e-5, ("dense", True): 1e-6, ("pcg", True): 1e-7}


def drift_graphs(x64: bool):
    """The reference's drift fixture as a graph of each package (float64 nodes and edges with x64)."""
    gt = circle_trajectory(40)
    est = drifted_trajectory(gt)
    T_rel = np.linalg.inv(gt[0]) @ gt[39]
    g = jpg.graph_from_trajectory(jnp.asarray(est, jnp.float32))
    g = jpg.add_edge(g, 39, 0, 39, jnp.asarray(T_rel, jnp.float32), weight=20.0)
    if x64:
        g = g._replace(nodes=jnp.asarray(est, jnp.float64), edge_T=g.edge_T.astype(jnp.float64),
                       edge_weight=g.edge_weight.astype(jnp.float64))
    tg = tpg.PoseGraph(*(torch.from_numpy(np.array(x)) for x in g))
    return g, tg._replace(edge_i=tg.edge_i.long(), edge_j=tg.edge_j.long()), est, gt


@pytest.fixture(scope="module", params=[False, True], ids=["float32", "float64"])
def optimized(request):
    x64 = request.param
    out = {}
    with jax.enable_x64(x64):
        g, tg, est, gt = drift_graphs(x64)
        for solver in ("dense", "pcg"):
            want = np.asarray(jpg.optimize_pose_graph(g, iterations=15, solver=solver).nodes)
            out[solver] = (want, tpg.optimize_pose_graph(tg, iterations=15, solver=solver).nodes.numpy())
    return x64, out, est, gt


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_matches_reference(optimized, solver):
    x64, out, est, gt = optimized
    want, got = out[solver]
    assert got.dtype == (np.float64 if x64 else np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[solver, x64])
    np.testing.assert_array_equal(got[0], est[0].astype(got.dtype))  # the gauge node
    rel = np.linalg.inv(got[0]) @ got[39]
    drift = np.linalg.norm(est[39, :3, 3] - gt[39, :3, 3])
    assert np.linalg.norm(rel[:3, 3] - (np.linalg.inv(gt[0]) @ gt[39])[:3, 3]) < 0.05 * drift


def _gradient(tg: tpg.PoseGraph, nodes: np.ndarray) -> float:
    """max |Jᵀ W r| over the free nodes of the float64 objective at ``nodes``."""
    g = tg._replace(nodes=torch.from_numpy(np.asarray(nodes, np.float64)), edge_T=tg.edge_T.double(),
                    edge_weight=tg.edge_weight.double())
    Ji, Jj, r = tpg.edge_blocks(g, g.nodes, torch.linalg.inv(g.edge_T))
    bi, bj = tpg._rhs(Ji, Jj, g.edge_weight, r)
    b = torch.zeros((g.nodes.shape[0], 6), dtype=torch.float64)
    b.index_add_(0, g.edge_i, bi).index_add_(0, g.edge_j, bj)
    return float(b[1:].abs().max())


def test_dense_and_pcg_agree_in_float64(optimized):
    """Float64: each solver of each package ends at a stationary point (gradient below 1e-8: measured
    3.1e-14 and 1.0e-10 for the port's dense and PCG, 1.2e-10 and 7.5e-11 for the reference's); the
    port's dense and PCG results 1.6e-7 apart (PCG's stopping rule), held at 1e-6."""
    x64, out, _, _ = optimized
    if not x64:
        return
    with jax.enable_x64(True):
        _, tg, _, _ = drift_graphs(True)
    for solver in ("dense", "pcg"):
        for who, nodes in zip(("reference", "port"), out[solver]):
            assert _gradient(tg, nodes) < 1e-8, (solver, who)
    np.testing.assert_allclose(out["dense"][1], out["pcg"][1], rtol=0, atol=1e-6)


def test_edge_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(0)
    E = 12
    w = rng.normal(size=(3, E, 3)) * 0.3
    Ts = np.tile(np.eye(4), (3, E, 1, 1))
    for k in range(3):
        Ts[k, :, :3, :3] = np.asarray(jax.vmap(jpg.so3_exp)(jnp.asarray(w[k], jnp.float32)))
        Ts[k, :, :3, 3] = rng.normal(size=(E, 3))
    Ts[2, :4] = Ts[0, :4] @ Ts[1, :4]  # residuals near the identity: so3_log's small-angle branch
    Ts = Ts.astype(np.float32)
    Ti, Tj, Tm = Ts[0], Ts[1], np.linalg.inv(Ts[2]).astype(np.float32)
    z = jnp.zeros(6, jnp.float32)
    jac = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=(0, 1)), in_axes=(None, None, 0, 0, 0))
    wJi, wJj = (np.asarray(x) for x in jac(z, z, jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Tm)))
    wr = np.asarray(jax.vmap(jpg._edge_residual, in_axes=(None, None, 0, 0, 0))(
        z, z, jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Tm)))
    g = tpg.empty_graph(2 * E, E)._replace(
        edge_i=torch.arange(E), edge_j=torch.arange(E, 2 * E))
    nodes = torch.from_numpy(np.concatenate([Ti, Tj]))
    gJi, gJj, gr = tpg.edge_blocks(g, nodes, torch.from_numpy(Tm))
    np.testing.assert_allclose(gJi.numpy(), wJi, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gJj.numpy(), wJj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), wr, rtol=1e-5, atol=1e-6)


def test_graph_from_trajectory_and_add_edge():
    gt = circle_trajectory(10)
    want = jpg.add_edge(jpg.graph_from_trajectory(jnp.asarray(gt, jnp.float32), max_edges=12), 9, 0, 9,
                        jnp.eye(4), weight=3.0)
    got = tpg.add_edge(tpg.graph_from_trajectory(torch.from_numpy(gt), max_edges=12), 9, 0, 9,
                       torch.eye(4), weight=3.0)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    consistent = tpg.optimize_pose_graph(tpg.graph_from_trajectory(torch.from_numpy(gt)), iterations=3)
    np.testing.assert_allclose(consistent.nodes.numpy(), gt, atol=1e-3)  # a consistent chain stays put
