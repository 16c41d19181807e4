"""The tiny cells' frame path: the benchmark's own wavefront path."""

from rtbench.frames.wavefront import PASSES, colour_state, frame_fn, reference_frames, reference_state  # noqa: F401
