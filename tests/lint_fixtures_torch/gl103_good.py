"""GL103 near-miss: the loop value rides in a static tensor (one step
serves every iteration), and a plain closure may capture freely."""
import torch

from hyperopt_tpu_torch.utils import capture_graph


def make_step(p, g, lr):
    def step():
        p.sub_(lr * g)              # lr: a static tensor filled per run
    return capture_graph(step, p.device)


def run(p, g, learning_rates):
    lr = torch.zeros((), device=p.device)
    graph = make_step(p, g, lr)
    logs = []
    for value in learning_rates:
        lr.fill_(value)
        graph.replay()
        def host_log(msg):
            return f"{msg} @ {value}"   # plain closure: no capture involved
        logs.append(host_log("step"))
    return logs
