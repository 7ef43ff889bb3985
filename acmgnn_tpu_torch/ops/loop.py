"""The split loop on the device (K9): a captured loop body run to its
stop rule in one graph launch, as JAX's ``lax.while_loop`` runs a split.

``DeviceLoop`` wraps the outer graph ``csrc/loop.cu`` builds around a
body captured with ``torch.cuda.CUDAGraph(keep_graph=True)``: a K9
launch that sets the loop's condition, then a conditional while node
whose body is the captured graph followed by K9 again.  The condition is
``loop_condition``: ``k < limit and not stop``, from device tensors the
body and its caller update in place.  ``launch`` runs every body the
condition admits with no host read; the caller reads ``k`` afterwards.
K9 replaces no TPU kernel (XLA lowers JAX's ``while_loop`` itself).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acmgnn_tpu_torch.ops import kernels

COUNTER = "k9_loop_cond"
# cudaGraphNodeType values (driver_types.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 13: "conditional"}


def loop_condition(k: torch.Tensor, limit: torch.Tensor,
                   stop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9's plain version: whether the loop runs another body."""
    go = k < limit
    return go if stop is None else go & ~stop


class DeviceLoop:
    """The outer graph around ``inner`` (a ``torch.cuda.CUDAGraph``
    captured with ``keep_graph=True``), instantiated once; ``launch`` runs
    it on the current stream.  ``inner`` (and its memory pool) must outlive
    the object; ``destroy`` frees the outer graph and its exec."""

    def __init__(self, inner, k: torch.Tensor, limit: torch.Tensor,
                 stop: Optional[torch.Tensor] = None):
        kernels.require_cuda(k, limit, *(() if stop is None else (stop,)))
        if k.dtype != torch.int64 or limit.dtype != torch.int64:
            raise ValueError("the loop's k and limit must be int64")
        if stop is not None and stop.dtype != torch.bool:
            raise ValueError("the loop's stop flag must be bool")
        self.lib = kernels.library("loop")
        self.exec, self.graph = ctypes.c_void_p(), ctypes.c_void_p()
        kernels.check(self.lib, self.lib.acm_k9_loop_build(
            inner.raw_cuda_graph(), k.data_ptr(), limit.data_ptr(),
            kernels.ptr(stop), ctypes.byref(self.exec),
            ctypes.byref(self.graph)), "K9 loop build")

    def launch(self) -> None:
        """One launch: K9, then the body and K9 while the condition holds.
        Counts nothing: the caller counts once it has read ``k``."""
        kernels.check(self.lib, self.lib.acm_k9_loop_launch(
            self.exec, kernels.stream()), "K9 loop launch")

    def destroy(self) -> None:
        if self.exec:
            kernels.check(self.lib, self.lib.acm_k9_loop_destroy(
                self.exec, self.graph), "K9 loop destroy")
        self.exec, self.graph = ctypes.c_void_p(), ctypes.c_void_p()

    def __del__(self):
        if getattr(self, "exec", None):
            self.lib.acm_k9_loop_destroy(self.exec, self.graph)


def count_bodies(bodies: int) -> None:
    """K9's launches in one loop launch that ran ``bodies`` bodies: the
    prologue's and one after each body."""
    kernels.launches[COUNTER] += bodies + 1


def node_types(graph) -> list:
    """The node types of a captured ``torch.cuda.CUDAGraph``
    (``keep_graph=True``) by name, child graphs' nodes inside ``[`` /
    ``]``."""
    lib = kernels.library("loop")
    cap = 1 << 16
    types = (ctypes.c_int * cap)()
    n = ctypes.c_int(0)
    kernels.check(lib, lib.acm_k9_node_types(graph.raw_cuda_graph(), types,
                                             cap, ctypes.byref(n)),
                  "graph node types")
    marks = {-1: "[", -2: "]"}
    return [marks.get(t, NODE_TYPES.get(t, str(t)))
            for t in types[:min(n.value, cap)]]
