"""The share of the material trainer's steps, over its life in the run,
that ran as the replay of its captured CUDA graph, in percent: 100 x
replayed / (replayed + eager), from the trainer's own count
(``graph_stats``), read as graph_replay_share reads the shape trainer's.
The stage-2 host dispatch layer's reach: an eager step pays for its
launches on the host.  None where the trainer keeps no such count (a
material trainer without the graph), or where it runs off the card."""
import os

from bench_port.harness.spec import load_module

read = load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 'graph_replay_share.py'),
    'bench_metric_graph_replay_share_of_mat').read
