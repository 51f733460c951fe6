"""The share of the trainer's steps, over its life in the run, that ran as
the replay of its captured CUDA graph, in percent: 100 x replayed /
(replayed + eager), from the trainer's own count (``graph_stats``).  The
host dispatch layer's reach: an eager step pays for its launches on the
host.  None where the trainer keeps no such count, or where it runs off
the card (no graph can engage there)."""


def read(ctx):
    system = getattr(ctx, 'system', None)
    trainer = getattr(system, 'trainer', None)
    stats = getattr(trainer, 'graph_stats', None)
    if not stats or getattr(system, 'device', None) is None \
            or system.device.type != 'cuda':
        return None
    steps = stats['replayed'] + stats['eager']
    return 100.0 * stats['replayed'] / steps if steps else None
