"""GL101 near-miss: the same host reads OUTSIDE any captured step, plus
literal-only scalar casts inside one (static config, not card values)."""
import numpy as np
import torch

from hyperopt_tpu_torch.utils import capture_graph


def make_step(x, out, n=4):
    def step():
        out.copy_(x * float(1e-3) + int(2))  # literals: no card value read
    return capture_graph(step, x.device)


def fetch(graph, out):
    graph.replay()
    host = np.asarray(out.cpu())   # outside the captured step: a real fetch
    return float(host.mean()), out.item() if out.ndim == 0 else None


def build(gamma):
    gamma_f = float(gamma)         # builder scope, never captured

    def step(x):
        return x * gamma_f
    return step


def nonzero_host(x):
    return torch.nonzero(x)        # host code: the sync is expected here
