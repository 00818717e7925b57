"""GL101 true positive: host reads inside a captured step."""
import numpy as np
import torch

from hyperopt_tpu_torch.utils import capture_graph


def make_step(x, out):
    def step():
        scale = x.sum().item()      # GL101: .item() reads the card
        out.copy_(x * scale)
    return capture_graph(step, x.device)


class Runner:
    def __init__(self, x):
        self.x = x
        self.out = torch.zeros_like(x)
        self.graph = capture_graph(self.step, x.device)

    def step(self):
        self._fill(self.x)

    def _fill(self, v):             # a same-file callee of the step
        host = np.asarray(v)        # GL101: materializes on the host
        self.out.copy_(v * float(host.mean()))  # GL101: float() of a value
        idx = torch.nonzero(v)      # GL101: nonzero syncs for its size
        torch.cuda.synchronize()  # graftlint: disable=GL202 GL101: a sync in the capture
        return idx
