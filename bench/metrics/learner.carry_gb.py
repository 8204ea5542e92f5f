"""learner.carry_gb: the learner carry's allocated bytes, in GB (1e9).

The program's own count (`OnlineTrainer.carry_nbytes()["alloc"]`, the
registry's `carry_alloc_bytes`): every tensor of the carry, the influence
values and row indices first among them."""


def read(ctx):
    got = ctx.get("counters", {}).get("carry_alloc_bytes")
    return None if got is None else got / 1e9
