"""GL201 true positive: a name bound to a graph's static output, or to
its static carry, read after a later replay that overwrote it."""
import torch

from hyperopt_tpu_torch.utils import capture_graph


def two_steps(model, static_in):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_out = model(static_in)
    g.replay()
    first = static_out              # an alias of the static output
    g.replay()
    return first.sum()              # GL201: the replay overwrote it


class Loop:
    def __init__(self, x):
        self.values = torch.zeros_like(x)
        self.graph = capture_graph(self.step, x.device)

    def step(self):
        self.values.add_(1.0)       # the static carry

    def run(self):
        self.graph.replay()
        before = self.values[0]     # a view of the carry
        self.graph.replay()
        return before + 1           # GL201: read after the next replay
