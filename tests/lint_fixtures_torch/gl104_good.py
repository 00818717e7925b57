"""GL104 near-miss: the capture and the build are hoisted out of the
loop (or made once behind a memo guard), so each happens once."""
from hyperopt_tpu_torch.tpe import build_suggest_fn
from hyperopt_tpu_torch.utils import capture_graph

_MEMO = []


def run(step, device, n):
    g = capture_graph(step, device)     # hoisted: one graph for all passes
    if not _MEMO:
        _MEMO.append(capture_graph(step, device))   # memo guard, not a loop
    for _ in range(n):
        g.replay()
    return g


def ask_all(ps, keys, state):
    fn = build_suggest_fn(ps, 24, 0.25, 25.0, 1.0)
    return [fn(key, *state, 1) for key in keys]
