"""Checks of a [V, B] predecessor table against the edges of a banded plan,
shared by the CPU tests and the card tests (numpy and the port only: no
JAX, so the card's machine can import it).

A predecessor p != v explains v's label d[v] within tol when p -> v is an
in-edge the plan relaxes (one of the eight banded classes with a finite
weight plane entry, or a residual edge) and d[p] + w(p -> v) <= d[v] * (1 +
tol) + tol in f32, the gate of the recoveries."""

import numpy as np

from mesh_navigation_torch.ops import banded_gpu as tbg

# (dr, dc) of the eight classes in class order (banded_gpu._class_offsets)
CLASS_SHIFTS = ((0, -1), (0, 1), (-1, -1), (-1, 0), (-1, 1), (1, -1), (1, 0), (1, 1))


def residual_entries(plan):
    """The real residual edges as real ids: (dst, src, w) numpy arrays."""
    n, C, Cp = plan.n_residual, plan.n_cols, plan.n_cols_pad
    dst = plan.res_dst[:n].cpu().numpy().astype(np.int64)
    src = plan.res_src[:n].cpu().numpy().astype(np.int64)
    return (dst // Cp) * C + dst % Cp, (src // Cp) * C + src % Cp, plan.res_w[:n].cpu().numpy()


def in_edges(plan):
    """Every in-edge the plan relaxes, sorted by key dst * R * C + src (real
    ids): (keys, w)."""
    R, C = plan.n_rows, plan.n_cols
    w8 = tbg._w8_planes(plan, R).cpu().numpy()[:, :, :C]
    r, c = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    dst, src, w = [], [], []
    for k, (dr, dc) in enumerate(CLASS_SHIFTS):
        ok = np.isfinite(w8[:, k])
        dst.append((r * C + c)[ok])
        src.append(((r + dr) * C + c + dc)[ok])
        w.append(w8[:, k][ok])
    rd, rs, rw = residual_entries(plan)
    keys = np.concatenate(dst + [rd]) * (R * C) + np.concatenate(src + [rs])
    w = np.concatenate(w + [rw]).astype(np.float32)
    order = np.argsort(keys, kind="stable")
    return keys[order], w[order]


def unexplained(plan, dist, pred, tol):
    """[V, B] bool: pred[v] != v and p -> v is no in-edge of the plan, or
    does not explain d[v] within tol."""
    V, B = dist.shape
    N = plan.n_rows * plan.n_cols
    keys, w = in_edges(plan)
    vid = np.broadcast_to(np.arange(V)[:, None], (V, B))
    ns = pred != vid
    v, b = np.nonzero(ns)
    p = pred[ns].astype(np.int64)
    assert p.min(initial=0) >= 0 and p.max(initial=0) < V
    i = np.clip(np.searchsorted(keys, v * N + p), 0, len(keys) - 1)
    found = keys[i] == v * N + p
    cost = dist[p, b] + w[i]
    lim = dist[v, b] * np.float32(1.0 + tol) + np.float32(tol)
    out = np.zeros((V, B), bool)
    out[v, b] = ~(found & (cost <= lim))
    return out


def best_in_edge(plan, dist):
    """[V, B] f32: the least d[src] + w over each vertex's in-edges."""
    V, B = dist.shape
    N = plan.n_rows * plan.n_cols
    keys, w = in_edges(plan)
    dst, src = keys // N, keys % N
    keep = (dst < V) & (src < V)
    best = np.full((V, B), np.inf, np.float32)
    np.minimum.at(best, dst[keep], dist[src[keep]] + w[keep, None])
    return best
