"""Host milliseconds a step of rank 0's profiled slice spends in the
program's `mesh.grad_reduce` span (the gradient bucket's all_reduce and the
read of the ranks' status that waits for it)."""

from portbench.program_trace import per_step_ms


def read(rec):
    return per_step_ms(rec, "mesh.grad_reduce")
