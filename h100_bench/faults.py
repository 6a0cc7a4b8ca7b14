"""Faults planted under a run's timed path, to show that the check fails
them: ``readings.py`` reads them on the card at the cell's size, and
``tests/test_check.py`` at a size the CPU holds. Each takes the loop's
entry (the port, or the reference in its place) and returns one that
goes wrong in one way:

* ``half_batch``: half of the batch left out (serving: the first half's
  answers stand for the rest; the sweep: half of the views, repeated;
  training: the step on the first half, its means over that half);
* ``altered``: an answer altered where it is produced (a patch of every
  frame brightened);
* ``unchanged_state``: a training step that leaves the parameters and
  the optimizer's moments as they were.
"""

from __future__ import annotations

import torch


def _half(x: torch.Tensor) -> torch.Tensor:
    h = (x.shape[0] + 1) // 2
    return torch.cat([x[:h], x[:x.shape[0] - h]])


class _Wrap:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class HalfBatch(_Wrap):
    def predict(self, image, K):
        ldi = self.inner.predict(image[:(image.shape[0] + 1) // 2], K)
        n = image.shape[0]
        return type(ldi)(torch.cat([ldi.textures, ldi.textures])[:n],
                         torch.cat([ldi.disparities, ldi.disparities])[:n],
                         K)

    def render(self, ldi, pose):
        return _half(self.inner.render(ldi, pose))

    def sweep(self, ldi, traffic):
        frames = self.inner.sweep(ldi, traffic)
        return _half(frames)

    def step(self, batch):
        h = (batch["src_image"].shape[0] + 1) // 2
        return self.inner.step({k: v[:h] for k, v in batch.items()})


class Altered(_Wrap):
    def _alter(self, frames):
        frames = frames.clone()
        frames[..., :4, :4, :] += 0.25
        return frames

    def render(self, ldi, pose):
        return self._alter(self.inner.render(ldi, pose))

    def sweep(self, ldi, traffic):
        return self._alter(self.inner.sweep(ldi, traffic))


class UnchangedState(_Wrap):
    def step(self, batch):
        params = self.inner.params()
        moment = self.inner.first_moment()
        keep = {k: p.detach().clone() for k, p in params.items()}
        kept_mu = {k: m.clone() for k, m in moment.items()}
        metrics = self.inner.step(batch)
        with torch.no_grad():
            for k, p in self.inner.params().items():
                p.copy_(keep[k])
        self._restore_moments(kept_mu)
        return metrics

    def _restore_moments(self, kept_mu):
        state = getattr(self.inner, "state", None)
        if state is not None:
            state.opt_state.mu.update(kept_mu)
        else:
            self.inner.adam.mu.update(kept_mu)


FAULTS = {"half_batch": HalfBatch, "altered": Altered,
          "unchanged_state": UnchangedState}
