"""GL102 near-miss: prints in host code around the captured step."""
from hyperopt_tpu_torch.utils import capture_graph


def diagnose(x):
    print("host-side inspection", x)    # not a captured step
    return x


def make_step(x, out):
    def hot():
        out.copy_(x * 2.0)
    graph = capture_graph(hot, x.device)
    print("captured")                   # after the capture, on the host
    return graph
