"""GL202 true positive: a product path holding the host until the card
drains."""
import torch


def suggest(program, key, values):
    out = program(key, values)
    torch.cuda.synchronize()        # GL202: sync in a product path
    done = torch.cuda.Event()
    done.record()
    done.synchronize()              # GL202: Event.synchronize
    torch.cuda.current_stream().synchronize()  # GL202: Stream.synchronize
    return out
