"""GL203 near-miss: the graph and the program are bound once and reused."""
from hyperopt_tpu_torch.tpe import build_suggest_fn
from hyperopt_tpu_torch.utils import capture_graph


def make(step, device):
    return capture_graph(step, device)


def run(graph):
    graph.replay()
    return graph


def make_ask(ps):
    fn = build_suggest_fn(ps, 24, 0.25, 25.0, 1.0)

    def ask(key, state):
        return fn(key, *state, 1)
    return ask
