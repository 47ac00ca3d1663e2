"""A dispatch mode that counts the aten ops dispatched under it (a copy of
`chip_smoke.py:_op_counter`). The kernels' ctypes launches pass no
dispatcher and are not counted."""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))
