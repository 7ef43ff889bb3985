"""Operations and bytes of one training epoch, from a configuration's
shapes, keyed by the mathematics and not by a kernel:

- a projection ``[m, k] @ [k, n]``: ``2·m·k·n`` operations in the
  projection's dtype (a backward product counts as its own projection);
- a sparse product ``Â Z`` of ``nnz`` entries over ``d`` columns:
  ``2·nnz·d`` operations in f32 (its sums are f32);
- the attention mix of ``T`` channels of width ``d`` over ``N`` rows:
  ``4·T·N·d`` operations forward (the scores' products and the weighted
  sum), ``8·T·N·d`` backward, in f32.

Counted as the plain reference performs the mathematics: the training
forward and backward and the evaluation forward of one epoch; the
hoisted aggregate ``Â X`` once in set-up and not in an epoch; no
recompute; element-wise work, the loss and Adam not at all.

The least bytes of the epoch's sparse traversals (``Traversal``): a
traversal reads its column indices once (4 bytes each), each operand row
once in the gather dtype, each residual row once (f32, the high-pass
columns ``z − Âz`` read ``z``), and writes each output row once (f32).
The traversals are those the configuration's path makes: one product
serves every operand of one operator at one point of the epoch (the
training and evaluation branches of the second layer share theirs), and
a backward product transposes only what takes a gradient.
"""

from __future__ import annotations

import dataclasses

ELEM = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass
class Traversal:
    what: str
    nnz: int
    rows: int
    d: int            # operand columns
    d_residual: int   # f32 residual columns read
    gather_dtype: str

    @property
    def bytes(self) -> int:
        return (4 * self.nnz + self.rows * (self.d * ELEM[self.gather_dtype]
                                            + 4 * self.d_residual
                                            + 4 * self.d))


@dataclasses.dataclass
class Counts:
    ops: list = dataclasses.field(default_factory=list)   # (what, n, dtype)
    traversals: list = dataclasses.field(default_factory=list)

    def gemm(self, what, m, k, n, dtype):
        self.ops.append((what, 2 * m * k * n, dtype))

    def spmm(self, what, nnz, d):
        self.ops.append((what, 2 * nnz * d, "float32"))

    def mix(self, what, t, rows, d, backward=False):
        self.ops.append((what, (8 if backward else 4) * t * rows * d,
                         "float32"))

    def flops(self) -> int:
        return sum(n for _, n, _ in self.ops)

    def seconds_at_peak(self, peaks: dict) -> float:
        return sum(n / peaks[dtype] for _, n, dtype in self.ops)

    def traversal_bytes(self) -> int:
        return sum(t.bytes for t in self.traversals)


def acm_two_layer(config: dict) -> Counts:
    """One joint epoch of ACM-GCN+ / ACM-GCN++ (``reference/acm.py``):
    ``data`` gives N, F, C, the operator's entries ``nnz_low`` (A + I)
    and ``nnz_raw`` (A); ``model`` the rest."""
    m, data = config["model"], config["data"]
    n, f, c, h = data["nodes"], data["features"], data["classes"], \
        m["hidden"]
    nnz_low, nnz_raw = data["nnz_low"], data["nnz_raw"]
    g, gd = m["gemm_dtype"], m["spmm_dtype"]
    pp = m["model_type"] == "acmgcnpp"
    structure = m["structure_info"]
    t = 4 if structure else 3
    hoist_train = m["hoist_first"] and f <= 128
    out = Counts()
    # training forward
    if pp:
        out.gemm("train fwd mlpX", n, f, h, g)
    if hoist_train:
        out.spmm("train fwd layer-1 gather A x", nnz_low, f)
        out.traversals.append(Traversal("train fwd layer-1 A x", nnz_low, n,
                                        f, 0, gd))
    else:
        out.spmm("train fwd layer-1 gather [zL|zH]", nnz_low, 2 * h)
        out.traversals.append(Traversal("train fwd layer-1 [zL|zH]",
                                        nnz_low, n, 2 * h, h, gd))
    for w in ("L", "H", "I"):
        out.gemm(f"train fwd layer-1 x W_{w}", n, f, h, g)
    if structure:
        # the structure gathers depend on parameters alone: one a layer
        # serves both branches
        for d, lay in ((h, 1), (c, 2)):
            out.spmm(f"fwd layer-{lay} structure A S", nnz_raw, d)
            out.traversals.append(Traversal(f"fwd layer-{lay} A S",
                                            nnz_raw, n, d, 0, gd))
    out.mix("train fwd layer-1 mix", t, n, h)
    for w in ("L", "H", "I"):
        out.gemm(f"train fwd layer-2 h W_{w}", n, h, c, g)
    out.spmm("train fwd layer-2 gather [zL|zH]", nnz_low, 2 * c)
    out.mix("train fwd layer-2 mix", t, n, c)
    # training backward
    out.mix("train bwd layer-2 mix", t, n, c, backward=True)
    out.spmm("train bwd layer-2 gather", nnz_low, 2 * c)
    out.traversals.append(Traversal("train bwd layer-2 Aᵀ[gL|gH]", nnz_low,
                                    n, 2 * c, c, gd))
    if structure:
        for d, lay in ((h, 1), (c, 2)):
            out.spmm(f"train bwd layer-{lay} structure Aᵀ g", nnz_raw, d)
            out.traversals.append(Traversal(f"train bwd layer-{lay} Aᵀ g",
                                            nnz_raw, n, d, 0, gd))
    for w in ("L", "H", "I"):
        out.gemm(f"train bwd layer-2 dW_{w}", h, n, c, g)
        out.gemm(f"train bwd layer-2 dh via W_{w}", n, c, h, g)
    out.mix("train bwd layer-1 mix", t, n, h, backward=True)
    if not hoist_train:
        out.spmm("train bwd layer-1 gather", nnz_low, 2 * h)
        out.traversals.append(Traversal("train bwd layer-1 Aᵀ[gL|gH]",
                                        nnz_low, n, 2 * h, h, gd))
    for w in ("L", "H", "I"):
        out.gemm(f"train bwd layer-1 dW_{w}", f, n, h, g)
    if pp:
        out.gemm("train bwd mlpX dW", f, n, h, g)
    # evaluation forward (layer 1 reads the hoisted aggregate)
    if pp:
        out.gemm("eval fwd mlpX", n, f, h, g)
    for w in (("L", "H", "I") if f <= 128 or not m["hoist_first"]
              else ("L", "H", "H from the aggregate", "I")):
        out.gemm(f"eval fwd layer-1 W_{w}", n, f, h, g)
    if not m["hoist_first"]:
        out.spmm("eval fwd layer-1 gather [zL|zH]", nnz_low, 2 * h)
    out.mix("eval fwd layer-1 mix", t, n, h)
    for w in ("L", "H", "I"):
        out.gemm(f"eval fwd layer-2 h W_{w}", n, h, c, g)
    out.spmm("eval fwd layer-2 gather [zL|zH]", nnz_low, 2 * c)
    # the second layer's product serves both branches' four operands
    out.traversals.append(Traversal("fwd layer-2 [zL|zH] both branches",
                                    nnz_low, n, 4 * c, 2 * c, gd))
    out.mix("eval fwd layer-2 mix", t, n, c)
    return out
