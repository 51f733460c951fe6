"""The share of the secondary trace's refinement candidates that found no
slot, over the profiled steps, in percent: sum(max(0, candidates -
slots)) / sum(candidates), the candidates from the trainer's own
candidate rate a step and the slots from the budget in force then (the
system's ``overflow_share``).  A candidate past the budget is reported a
miss, so a gain in speed that drops traced rays shows here.  None where
the system keeps no such count."""


def read(ctx):
    share = getattr(getattr(ctx, 'system', None), 'overflow_share', None)
    return share() if callable(share) else None
