"""GL203 true positive: capture-then-replay and build-then-call in one
expression -- a fresh graph or program per invocation."""
from hyperopt_tpu_torch.tpe import build_suggest_fn
from hyperopt_tpu_torch.utils import capture_graph


def run(step, device):
    return capture_graph(step, device).replay()    # GL203


def ask(ps, key, state):
    return build_suggest_fn(ps, 24, 0.25, 25.0, 1.0)(key, *state, 1)  # GL203
