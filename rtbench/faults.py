"""Faults planted under the timed path, to show that ``correct`` comes out
false when the frame is wrong: each wraps the program's frame function
(``frame_fn(film, cam, frame_index) -> (film, display)``). A cell on one
card has no exchange between chips to leave out.

- ``state_unchanged``: the frame runs but returns its film unchanged.
- ``half_batch``: half of the frame's pixels (every other row) are left
  out of the film's blend.
- ``answer_altered``: the display of the window's second frame is scaled
  by 0.9 where it is produced.

Used by ``calibrate.py --faults`` on the card and by the tests on the CPU;
never by the benchmark's runs."""

from __future__ import annotations

import torch


def state_unchanged(frame_fn, prog):
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import postprocess

    def frame(film, cam, fi):
        frame_fn(film, cam, fi)
        return film_mod.Film(accum=film.accum, frame_index=film.frame_index + 1), postprocess.postprocess(film.accum)

    return frame


def half_batch(frame_fn, prog):
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.render import postprocess

    def frame(film, cam, fi):
        old = film.accum.clone()
        new, _ = frame_fn(film, cam, fi)
        keep = torch.zeros((old.shape[0], 1, 1), dtype=torch.bool, device=old.device)
        keep[::2] = True
        accum = torch.where(keep, new.accum, old)
        return film_mod.Film(accum=accum, frame_index=new.frame_index), postprocess.postprocess(accum)

    return frame


def answer_altered(frame_fn, prog, frame_index: int = 3):
    def frame(film, cam, fi):
        new, disp = frame_fn(film, cam, fi)
        return new, (disp * 0.9 if fi == frame_index else disp)

    return frame


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "answer_altered": answer_altered}
