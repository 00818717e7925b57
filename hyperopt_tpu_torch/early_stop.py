"""Stock early-stopping functions for ``fmin(early_stop_fn=...)``: the
port's copy of :mod:`hyperopt_tpu.early_stop` (``no_progress_loss``)."""

from __future__ import annotations

__all__ = ["no_progress_loss"]


def no_progress_loss(iteration_stop_count=20, percent_increase=0.0):
    """Stop if the best loss has not improved for ``iteration_stop_count``
    iterations (improvement must exceed ``percent_increase`` percent).
    """

    def stop_fn(trials, best_loss=None, iteration_no_progress=0):
        new_loss = trials.trials[len(trials.trials) - 1]["result"].get("loss")
        if new_loss is None:
            return False, [best_loss, iteration_no_progress + 1]
        if best_loss is None:
            return False, [new_loss, 0]
        best_loss_threshold = best_loss - abs(best_loss * (percent_increase / 100.0))
        if new_loss < best_loss_threshold:
            best_loss = new_loss
            iteration_no_progress = 0
        else:
            iteration_no_progress += 1
        return (
            iteration_no_progress >= iteration_stop_count,
            [best_loss, iteration_no_progress],
        )

    return stop_fn
