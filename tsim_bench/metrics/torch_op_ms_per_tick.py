"""torch_op_ms_per_tick: device ms a tick of PyTorch's own device work:
the kernels in PyTorch's namespaces (`at::`, `at_cuda_detail::`,
`c10::`: its elementwise, index, reduce, scan and sort kernels) and the
copies and memsets that its operations make.  That is the torch op
chains: lights, post-move, routing glue, the megakernel's segment
preparation and state.  A kernel written for the program is in no such
namespace, so work that a later change moves into one leaves this
metric."""

import re

TORCH_KERNEL = re.compile(r"\b(at|at_cuda_detail|c10)::")
TORCH_COPY = re.compile(r"^(Memcpy|Memset)")


def is_torch(name: str) -> bool:
    return bool(TORCH_KERNEL.search(name) or TORCH_COPY.match(name))


def read(t):
    ns = sum(d for name, _, d in t.device if is_torch(name))
    if not ns:
        return None
    return ns / 1e6 / t.ticks
