"""GL102 true positive: a debug print left inside a captured step."""
from hyperopt_tpu_torch.utils import capture_graph


def make_step(x, out):
    def hot():
        print("x =", x)             # GL102: runs once, at capture
        out.copy_(x * 2.0)
    return capture_graph(hot, x.device)
