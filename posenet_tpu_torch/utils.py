"""The reference's `posenet.utils` surface, as `posenet_tpu.utils` has it:
the host preprocessing helpers (`preprocess`) and the overlay drawing
(`draw`)."""

from posenet_tpu_torch.draw import (draw_keypoints, draw_skel_and_kp,  # noqa: F401
                                    draw_skeleton, get_adjacent_keypoints)
from posenet_tpu_torch.preprocess import (process_input, read_cap,  # noqa: F401
                                          read_imgfile, valid_resolution)

# The reference names its core preprocessor with a leading underscore and
# callers import it so; keep the alias.
_process_input = process_input
