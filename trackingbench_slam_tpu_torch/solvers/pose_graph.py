"""Pose-graph optimization over a trajectory with loop edges.

Port of trackingbench_slam_tpu/solvers/pose_graph.py. Poses are (K, 4, 4)
world->camera; edges a fixed-capacity batch (edge_i, edge_j, T_meas_ij =
measured T_i T_j^-1, weight, valid). The residual of an edge is
log(T_meas^-1 T_i T_j^-1); its 6x6 Jacobians with respect to
left-multiplied increments on both poses come from torch.func.jacfwd,
vmapped over the edges, as the reference takes them with jax.jacfwd. Gauss-
Newton blocks go into the dense (6K, 6K) system, pose 0 is clamped, one
Cholesky (NaN step on failure, rejected), LM accept/reject on the device.

At the first iteration of a loop correction every odometry residual is
exactly log(I): se3's double-where guards keep the forward-mode derivative
finite there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.solvers.local_ba import \
    cholesky_solve_or_nan


class PoseGraph(NamedTuple):
    T_cw: torch.Tensor     # (K, 4, 4)
    edge_i: torch.Tensor   # (E,) int
    edge_j: torch.Tensor   # (E,) int
    T_meas: torch.Tensor   # (E, 4, 4) measured T_i T_j^-1
    weight: torch.Tensor   # (E,) scalar information
    valid: torch.Tensor    # (E,) bool


def edge_residual(T_i, T_j, T_meas):
    """(..., 6) se(3) residual log(T_meas^-1 T_i T_j^-1)."""
    return se3.log(se3.compose(se3.inverse(T_meas),
                               se3.compose(T_i, se3.inverse(T_j))))


def _residual_of_increments(xi_i, xi_j, T_i, T_j, T_meas):
    return edge_residual(se3.compose(se3.exp(xi_i), T_i),
                         se3.compose(se3.exp(xi_j), T_j), T_meas)


_jac_i = vmap(jacfwd(_residual_of_increments, argnums=0))
_jac_j = vmap(jacfwd(_residual_of_increments, argnums=1))


def edge_jacobians(T_i, T_j, T_meas):
    """(E, 6, 6) d r / d xi_i and d r / d xi_j at xi = 0."""
    z = torch.zeros(T_i.shape[:-2] + (6,), dtype=T_i.dtype,
                    device=T_i.device)
    return (_jac_i(z, z, T_i, T_j, T_meas), _jac_j(z, z, T_i, T_j, T_meas))


def optimize_pose_graph(g: PoseGraph, iters: int = 20,
                        init_lambda: float = 1e-6, fix_first: bool = True):
    """Returns (T_cw (K, 4, 4), final cost)."""
    K = g.T_cw.shape[0]
    dev = g.T_cw.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    w = (g.weight * g.valid).float()

    def residuals(T_cw):
        return edge_residual(T_cw[ei], T_cw[ej], g.T_meas)

    def cost_of(T_cw):
        r = residuals(T_cw)
        return ((r * r).sum(-1) * g.weight * g.valid).sum()

    def build(T_cw):
        T_i, T_j = T_cw[ei], T_cw[ej]
        r = edge_residual(T_i, T_j, g.T_meas)
        Ji, Jj = edge_jacobians(T_i, T_j, g.T_meas)
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        blocks = torch.cat([torch.einsum("eij,eik->ejk", a, b)
                            for a, b in ((Jiw, Ji), (Jjw, Jj), (Jiw, Jj),
                                         (Jjw, Ji))])
        pairs = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej,
                           ej * K + ei])
        H = torch.zeros((K * K, 6, 6), dtype=torch.float32,
                        device=dev).index_add(0, pairs, blocks)
        H = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3)
        b = torch.zeros((K, 6), dtype=torch.float32, device=dev).index_add(
            0, torch.cat([ei, ej]),
            torch.cat([-torch.einsum("eij,ei->ej", Jiw, r),
                       -torch.einsum("eij,ei->ej", Jjw, r)]))
        return H, b

    eye = torch.eye(6 * K, dtype=torch.float32, device=dev)
    free = torch.ones((K,), dtype=torch.float32, device=dev)
    if fix_first:
        free[0] = 0.0
    clamp_diag = torch.diag_embed((1.0 - free)[:, None].expand(K, 6)
                                  .reshape(-1))
    T_cw = g.T_cw
    lam = torch.full((), init_lambda, dtype=torch.float32, device=dev)
    cost = cost_of(T_cw)
    for _ in range(iters):
        H, b = build(T_cw)
        # clamp pose 0: identity row/column block, zero right-hand side
        H = H * free[:, None, None, None] * free[None, None, :, None]
        Hd = H.reshape(6 * K, 6 * K) + clamp_diag + lam * eye
        dx = cholesky_solve_or_nan(Hd, (b * free[:, None]).reshape(-1))
        T_new = se3.compose(se3.exp(dx.reshape(K, 6)), T_cw)
        c_new = cost_of(T_new)
        accept = c_new < cost
        T_cw = torch.where(accept, T_new, T_cw)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-12),
                          torch.clamp(lam * 10.0, max=1e6))
        cost = torch.where(accept, c_new, cost)
    return se3.normalize(T_cw), cost


def odometry_chain_edges(T_cw: torch.Tensor):
    """Consecutive-pose odometry edges (i, j, T_i T_j^-1) of a trajectory."""
    K = T_cw.shape[0]
    i = torch.arange(K - 1, device=T_cw.device)
    j = i + 1
    return i, j, se3.compose(T_cw[i], se3.inverse(T_cw[j]))
