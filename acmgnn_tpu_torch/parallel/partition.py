"""Row partition of the graph over the ranks of the sharded path.

Counterpart of ``acmgnn_tpu/parallel/partition.py``, as numpy/scipy
copies with the same outputs: nnz-balanced contiguous blocks
(``partition_rows``), the streaming Fennel and serpentine-by-degree
assignments with their contiguity permutation, each rank's block triplets
in the padded node layout (``build_sharded_coo``), and the deduplicated
halo schedule (``build_halo_schedule``).

``build_sharded_coo`` returns each rank's triplets unpadded: the JAX
package pads every block to one ``[P, nnz_pad]`` shape for its uniform
SPMD program, where each rank here owns its own arrays.  Not ported:
``build_sharded_ell``, ``ell_class_widths`` and
``sharded_ell_work_accounting``, the TPU's per-class plane layout (classes
padded to the cross-partition maximum, per-partition dense hub blocks)
and its accounting.  A rank's local ELL half is the single-chip port's
degree-sorted CSR (``ops/ell.py``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def partition_rows(adj: sp.spmatrix, n_parts: int) -> np.ndarray:
    """nnz-balanced contiguous row partition: ``boundaries`` of length
    ``n_parts + 1``, part ``i`` owning rows ``boundaries[i]:boundaries[i+1]``."""
    csr = sp.csr_matrix(adj)
    n = csr.shape[0]
    if n_parts <= 1:
        return np.array([0, n], dtype=np.int64)
    cum = csr.indptr[1:].astype(np.float64)  # cumulative nnz after each row
    total = cum[-1] if cum[-1] > 0 else 1.0
    targets = total * np.arange(1, n_parts) / n_parts
    cuts = np.searchsorted(cum, targets, side="left") + 1
    boundaries = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    return np.maximum.accumulate(boundaries)


def fennel_partition(adj: sp.spmatrix, n_parts: int, gamma: float = 1.5,
                     slack: float = 1.05, passes: int = 2,
                     order: str = "degree") -> np.ndarray:
    """Streaming Fennel (Tsourakakis et al., WSDM'14) with degree-weighted
    loads under a hard cap: each node goes to the part maximizing
    ``|N(v) ∩ P| − α·γ·load(P)^(γ−1)``; ``passes > 1`` re-streams.
    Returns ``part[N]`` int32."""
    csr = sp.csr_matrix(adj)
    n = csr.shape[0]
    if n_parts <= 1:
        return np.zeros(n, np.int32)
    indptr, indices = csr.indptr, csr.indices
    deg = np.diff(indptr).astype(np.int64)
    total_load = float(max(csr.nnz, 1))
    cap = slack * total_load / n_parts
    alpha = total_load * (n_parts ** (gamma - 1.0)) / (total_load ** gamma)
    if order == "degree":
        visit = np.argsort(-deg, kind="stable")
    elif order == "bfs":
        from scipy.sparse.csgraph import breadth_first_order

        seen = np.zeros(n, bool)
        visit = []
        for seed in np.argsort(-deg, kind="stable"):
            if seen[seed]:
                continue
            bfs = breadth_first_order(csr, int(seed), directed=False,
                                      return_predecessors=False)
            seen[bfs] = True
            visit.append(bfs)
        visit = np.concatenate(visit) if visit else np.arange(n)
    else:
        visit = np.arange(n)

    part = np.full(n, -1, np.int32)
    loads = np.zeros(n_parts, np.float64)
    for _ in range(max(passes, 1)):
        for v in visit:
            w = float(deg[v])
            p_old = part[v]
            if p_old >= 0:
                loads[p_old] -= w
            nbr_parts = part[indices[indptr[v]: indptr[v + 1]]]
            nbr_parts = nbr_parts[nbr_parts >= 0]
            score = np.bincount(nbr_parts, minlength=n_parts).astype(
                np.float64)
            score -= alpha * gamma * np.power(loads, gamma - 1.0)
            over = loads + w > cap
            if not over.all():
                score[over] = -np.inf
            p_new = int(np.argmax(score))
            part[v] = p_new
            loads[p_new] += w
    return part


def degree_balanced_partition(adj: sp.spmatrix, n_parts: int) -> np.ndarray:
    """Serpentine-by-degree assignment: rows in descending degree order
    are dealt across the parts 0..P-1, P-1..0, ...  Returns ``part[N]``
    int32."""
    csr = sp.csr_matrix(adj)
    n = csr.shape[0]
    if n_parts <= 1:
        return np.zeros(n, np.int32)
    order = np.argsort(-np.diff(csr.indptr), kind="stable")
    part = np.empty(n, np.int32)
    ranks = np.arange(n)
    fwd = (ranks // n_parts) % 2 == 0
    part[order] = np.where(fwd, ranks % n_parts,
                           n_parts - 1 - (ranks % n_parts)).astype(np.int32)
    return part


def partition_to_perm(part: np.ndarray, n_parts: int):
    """Node permutation making each part's rows contiguous, and the
    resulting ``boundaries``; apply as ``adj[perm][:, perm]``, ``x[perm]``."""
    perm = np.argsort(part, kind="stable").astype(np.int64)
    counts = np.bincount(part, minlength=n_parts)
    boundaries = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return perm, boundaries


def _block_triplets(csr: sp.csr_matrix, r0: int, r1: int):
    """COO triplets of rows [r0, r1) with local row ids, CSR-ordered."""
    block = csr[r0:r1]
    coo = block.tocoo()
    if block.has_sorted_indices:   # already in (row, col) order: no sort
        return (coo.row.astype(np.int32), coo.col.astype(np.int32),
                coo.data.astype(np.float32))
    order = np.lexsort((coo.col, coo.row))
    return (coo.row[order].astype(np.int32), coo.col[order].astype(np.int32),
            coo.data[order].astype(np.float32))


def padded_ids(boundaries: np.ndarray, rows_per_part: int) -> np.ndarray:
    """Node j of part p -> ``p * rows_per_part + local(j)``, the row of its
    value in the padded node layout (``pad_node_array``)."""
    n_parts = len(boundaries) - 1
    out = np.zeros(int(boundaries[-1]), dtype=np.int32)
    for i in range(n_parts):
        r0, r1 = int(boundaries[i]), int(boundaries[i + 1])
        out[r0:r1] = i * rows_per_part + np.arange(r1 - r0, dtype=np.int32)
    return out


def build_sharded_coo(adj_op: sp.spmatrix, n_parts: int,
                      boundaries: np.ndarray | None = None) -> dict:
    """Each rank's block of the operator and of its transpose as COO
    triplets: local row ids, columns in the padded node layout, f32
    values, unpadded (lists of ``n_parts`` arrays).

    Keys: ``row_l``/``col``/``val`` (A), ``row_l_t``/``col_t``/``val_t``
    (Aᵀ), ``rows_per_part`` (the largest part), ``boundaries``,
    ``num_nodes``, ``nnz``.  The JAX package's arrays are these, padded to
    a common length with ``row_l = rows_per_part``.
    """
    csr = sp.csr_matrix(adj_op)
    csr_t = csr.T.tocsr()
    n = csr.shape[0]
    if boundaries is None:
        boundaries = partition_rows(csr, n_parts)
    boundaries = np.asarray(boundaries, np.int64)
    rows_per_part = max(int(np.max(np.diff(boundaries))), 1)
    pid = padded_ids(boundaries, rows_per_part)

    def blocks(mat):
        trip = [_block_triplets(mat, int(boundaries[i]),
                                int(boundaries[i + 1]))
                for i in range(n_parts)]
        return ([r for r, _, _ in trip], [pid[c] for _, c, _ in trip],
                [v for _, _, v in trip])

    row_l, col, val = blocks(csr)
    row_l_t, col_t, val_t = blocks(csr_t)
    return {
        "row_l": row_l, "col": col, "val": val,
        "row_l_t": row_l_t, "col_t": col_t, "val_t": val_t,
        "rows_per_part": rows_per_part, "boundaries": boundaries,
        "num_nodes": n, "nnz": int(csr.nnz),
    }


def build_halo_schedule(blocks: dict, pad_multiple: int = 8) -> dict:
    """Deduplicated boundary-row (halo) exchange schedule, for the operator
    and for its transpose.

    For every (owner q, consumer p) pair it lists the distinct local rows
    of q that p's block references, so the exchange is one uniform
    ``all_to_all`` of ``[P, halo_pad, d]`` send slabs instead of an
    all-gather.  Returns (``_t``: the transpose's):

    - ``col_h``: each rank's columns remapped into its receive buffer
      ``[own block (rows_per_part) | halo slabs (P * halo_pad)]``: an own
      column keeps its local id, a column of remote part q at rank r of its
      need-list becomes ``rows_per_part + q * halo_pad + r``;
    - ``send_idx``: ``[P(owner), P(dest), halo_pad]`` local rows each owner
      gathers into its send slabs (unused slots send row 0, which no
      remapped column references);
    - ``halo_pad``: the slab width, rounded up to ``pad_multiple``;
    - ``halo_rows``: real (unpadded) halo rows over all pairs.
    """
    rows_per_part = int(blocks["rows_per_part"])
    n_parts = len(blocks["row_l"])

    def schedule(col):
        need = [[None] * n_parts for _ in range(n_parts)]
        for p in range(n_parts):
            cols_p = np.unique(col[p])
            owner = cols_p // rows_per_part
            local = cols_p % rows_per_part
            for q in range(n_parts):
                if q != p:
                    need[p][q] = local[owner == q]
        sizes = [nd.size for row in need for nd in row if nd is not None]
        halo_rows = sum(sizes)
        h_max = max(sizes, default=0)
        halo_pad = max(pad_multiple,
                       -(-max(h_max, 1) // pad_multiple) * pad_multiple)
        send_idx = np.zeros((n_parts, n_parts, halo_pad), dtype=np.int32)
        col_h = []
        for p in range(n_parts):
            remap = np.zeros(n_parts * rows_per_part, dtype=np.int32)
            own0 = p * rows_per_part
            remap[own0: own0 + rows_per_part] = np.arange(rows_per_part,
                                                          dtype=np.int32)
            for q in range(n_parts):
                if q == p:
                    continue
                ids = need[p][q]
                send_idx[q, p, : ids.size] = ids
                remap[q * rows_per_part + ids] = (
                    rows_per_part + q * halo_pad
                    + np.arange(ids.size, dtype=np.int32))
            col_h.append(remap[col[p]])
        return col_h, send_idx, halo_pad, halo_rows

    col_h, send_idx, halo_pad, halo_rows = schedule(blocks["col"])
    col_h_t, send_idx_t, halo_pad_t, halo_rows_t = schedule(blocks["col_t"])
    return {
        "col_h": col_h, "send_idx": send_idx, "halo_pad": halo_pad,
        "halo_rows": halo_rows, "col_h_t": col_h_t,
        "send_idx_t": send_idx_t, "halo_pad_t": halo_pad_t,
        "halo_rows_t": halo_rows_t,
    }


def pad_node_array(arr: np.ndarray, boundaries: np.ndarray,
                   rows_per_part: int) -> np.ndarray:
    """Re-lay a [N, ...] node array into [P * rows_per_part, ...] so each
    part's slab holds its rows, zero padded."""
    n_parts = len(boundaries) - 1
    out = np.zeros((n_parts * rows_per_part,) + arr.shape[1:], dtype=arr.dtype)
    for i in range(n_parts):
        r0, r1 = int(boundaries[i]), int(boundaries[i + 1])
        out[i * rows_per_part: i * rows_per_part + (r1 - r0)] = arr[r0:r1]
    return out


def unpad_node_array(arr: np.ndarray, boundaries: np.ndarray,
                     rows_per_part: int) -> np.ndarray:
    """Inverse of ``pad_node_array``."""
    n_parts = len(boundaries) - 1
    return np.concatenate([
        arr[i * rows_per_part: i * rows_per_part
            + int(boundaries[i + 1]) - int(boundaries[i])]
        for i in range(n_parts)], axis=0)
