"""GL201 near-miss: the static output is cloned before the next replay,
and the carry is read afresh after each replay."""
import torch

from hyperopt_tpu_torch.utils import capture_graph


def two_steps(model, static_in):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_out = model(static_in)
    g.replay()
    first = static_out.clone()      # a copy, not an alias
    g.replay()
    return first.sum() + static_out.sum()   # the live output is fresh


class Loop:
    def __init__(self, x):
        self.values = torch.zeros_like(x)
        self.graph = capture_graph(self.step, x.device)

    def step(self):
        self.values.add_(1.0)

    def run(self):
        self.graph.replay()
        before = self.values[0].clone()
        self.graph.replay()
        now = self.values[0]        # bound after the replay it reads
        return before + now
