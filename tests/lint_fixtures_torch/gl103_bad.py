"""GL103 true positive: captured steps defined in a loop close over the
loop variable -- each is captured after the loop, at its last value."""
import torch

from hyperopt_tpu_torch.utils import capture_graph


def make_steps(p, g, learning_rates):
    steps = []
    for lr in learning_rates:
        def step():
            p.sub_(lr * g)          # GL103: captures loop-carried `lr`
        steps.append(step)
    return [capture_graph(s, p.device) for s in steps]
