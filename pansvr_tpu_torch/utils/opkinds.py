"""The ATen op kinds a block of code dispatches on one device type.

On a card, the first launch of a libtorch kernel loads the CUDA module
that holds it, and that costs host memory for the rest of the process
(up to 100 MiB a module on an H100 with torch 2.11). `OpKinds` is a
TorchDispatchMode that records each op kind (the overload's name, as
"aten::sort.stable") dispatched on tensors of its device type while it
is entered, with the process's VmRSS growth across that kind's first
call: the module its kernel loaded, where it loaded one.

    kinds = OpKinds("cuda")
    with kinds:
        ...                      # may be entered again, later
    kinds.kinds                  # {name: first-use VmRSS growth, GiB}
    kinds.new_since(other)       # the names `other` never recorded

Only ops that reach the Python dispatch key are seen: a composite op
shows as the ops it is made of, and a kernel launched by hand (ctypes)
is no op at all. Views and factories count like any other op.

TorchDispatchMode wraps a subclass's __torch_dispatch__ in
torch._disable_dynamo, whose first call imports torch._dynamo (sympy,
torch.distributed.tensor, ...): seconds of set-up and a few hundred MiB
of host memory for a recorder that never compiles. The method is set
again after the class is made, unwrapped.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .memory import vmrss_gib


def _on(device_type: str, *trees) -> bool:
    for tree in trees:
        for x in tree_flatten(tree)[0]:
            if isinstance(x, torch.Tensor) and x.device.type == device_type:
                return True
            if isinstance(x, torch.device) and x.type == device_type:
                return True
    return False


class OpKinds(TorchDispatchMode):
    """Records the op kinds dispatched on `device_type` while entered:
    `kinds` maps each name to the VmRSS growth across its first call
    (GiB; 0.0 where /proc is missing)."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.kinds: dict[str, float] = {}

    def _record(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name()
        if name in self.kinds:
            return func(*args, **kwargs)
        r0 = vmrss_gib()
        out = func(*args, **kwargs)
        if _on(self.device_type, args, kwargs, out):
            r1 = vmrss_gib()
            self.kinds[name] = (r1 - r0) if r0 is not None \
                and r1 is not None else 0.0
        return out

    def new_since(self, other: "OpKinds") -> dict[str, float]:
        """{name: growth} of the kinds recorded here and not in `other`."""
        return {k: v for k, v in self.kinds.items() if k not in other.kinds}


OpKinds.__torch_dispatch__ = OpKinds._record
