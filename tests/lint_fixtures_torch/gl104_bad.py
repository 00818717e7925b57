"""GL104 true positive: graphs and programs constructed inside a loop --
a fresh capture (or build) per iteration."""
import torch

from hyperopt_tpu_torch.tpe import build_suggest_fn
from hyperopt_tpu_torch.utils import capture_graph


def run(steps, device):
    outs = []
    for step in steps:
        g = capture_graph(step, device)     # GL104: a capture per pass
        g.replay()
        outs.append(torch.cuda.CUDAGraph())  # GL104: a graph per pass
    return outs


def ask_all(ps, keys, state):
    out = []
    for key in keys:
        fn = build_suggest_fn(ps, 24, 0.25, 25.0, 1.0)  # GL104
        out.append(fn(key, *state, 1))
    return out
