"""Demo render loops: the novel-view orbit, the gaze sweep, latent
morphing, and GIF export.

The port's counterpart of the JAX package's ``eval/render_loops.py``
(upstream ``utils/render_utils.py`` ``RenderUtils`` and the GIF export of
``evaluate_single_image``): the same cameras, gaze trajectories, frame
order and uint8 conversion (``x * 255``, clipped, truncated).  Each frame
is a no-gradient render of ``merge_img`` alone (the fields, through K1 on
the fused path, and one renderer pass: the forward's other three passes
do not reach it); the frames stay on the device until the loop ends and
come back to the host in one copy.  GIFs are written by ``utils/gif.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gazenerf_tpu_torch.config import ModelConfig
from gazenerf_tpu_torch.data.cameras import base_camera, orbit_cameras
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.utils.gif import write_gif

# the 45-frame gaze trajectory of the head orbit (upstream
# utils/render_utils.py)
ORBIT_GAZE_H = [-0.3, -0.3, -0.3, -0.3, -0.3, -0.2, -0.2, -0.2, -0.1, -0.1,
                -0.1, 0.0, 0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 0.3, 0.3, 0.3, 0.3,
                0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.2, 0.2, 0.2, 0.1, 0.0, -0.1,
                -0.2, -0.2, -0.2, -0.3, -0.3, -0.3, -0.3, -0.3, -0.3, -0.3, -0.3]
ORBIT_GAZE_V = [0.0, -0.1, -0.2, -0.2, -0.3, -0.3, -0.4, -0.4, -0.4, -0.4,
                -0.4, -0.4, -0.4, -0.4, -0.4, -0.4, -0.4, -0.4, -0.3, -0.3,
                -0.2, -0.2, -0.1, 0.0, 0.1, 0.2, 0.2, 0.3, 0.3, 0.4, 0.4, 0.4,
                0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.3, 0.3, 0.2, 0.2, 0.1, 0.0]


def gaze_sweep_trajectory() -> List[List[float]]:
    """The rectangular gaze sweep, 44 (pitch, yaw) points (upstream
    ``utils/render_utils.py``)."""
    traj = [[-0.20, j / 100.0] for j in range(-50, 51, 10)]
    traj += [[j / 100.0, 0.50] for j in range(-20, 21, 4)]
    traj += [[0.20, j / 100.0] for j in range(50, -51, -10)]
    traj += [[j / 100.0, -0.50] for j in range(20, -21, -4)]
    return traj


class RenderLoops:
    """Frame loops over one model configuration; each call takes the model
    (a ``GazeNeRF`` of ``cfg``) and ``[1, 179]`` / ``[1, 127]`` codes on the
    model's device, and returns ``[H, W, 3]`` uint8 frames."""

    def __init__(self, cfg: ModelConfig, view_num: int = 45):
        self.cfg = cfg
        self.view_num = view_num
        self.cams = orbit_cameras(view_num, cfg.featmap_size)
        self.base_cam = base_camera(cfg.featmap_size)

    @torch.no_grad()
    def _render(self, model, xy, shape_code, appea_code, gaze, cam) -> torch.Tensor:
        fm = model.render_featmaps(xy, shape_code, appea_code, gaze, cam["Rmats"],
                                   cam["Tvecs"], cam["inv_inmats"])["featmaps"]["merge"]
        img = model.neural_render(fm)[0].to(torch.float32)
        return (img * 255.0).clamp(0, 255).to(torch.uint8)

    def _run(self, model, items) -> List[np.ndarray]:
        """Render ``(shape_code, appea_code, gaze [1, 2], cam)`` (numpy gaze
        and camera) per frame on the model's device; one copy to the host at
        the end."""
        device = next(model.parameters()).device
        xy = pixel_grid(self.cfg.featmap_size, device=device)[None]
        frames = [self._render(model, xy, sc, ac, torch.as_tensor(gz, device=device),
                               {k: torch.as_tensor(v, device=device) for k, v in cam.items()})
                  for sc, ac, gz, cam in items]
        return list(torch.stack(frames).cpu().numpy())

    def render_novel_views(self, model, shape_code, appea_code,
                           move_gaze: bool = True) -> List[np.ndarray]:
        """The orbit of ``view_num`` cameras; the gaze follows the orbit
        trajectory, or stays at (0, -0.5)."""
        items = []
        for i, cam in enumerate(self.cams[: self.view_num]):
            gz = ([[ORBIT_GAZE_H[i % 45], ORBIT_GAZE_V[i % 45]]] if move_gaze else [[0.0, -0.5]])
            items.append((shape_code, appea_code, np.array(gz, np.float32), cam))
        return self._run(model, items)

    def render_gaze_sweep(self, model, shape_code, appea_code,
                          cam: Optional[Dict] = None) -> List[np.ndarray]:
        """The 44-point gaze sweep from ``cam`` (the frontal camera)."""
        cam = self.base_cam if cam is None else cam
        return self._run(model, [(shape_code, appea_code, np.array([gz], np.float32), cam)
                                 for gz in gaze_sweep_trajectory()])

    def render_morphing(self, model, codes_1, codes_2, nums: int = 16) -> List[np.ndarray]:
        """Linear interpolation from ``codes_1`` to ``codes_2`` (dicts with
        ``shape_code`` and ``appea_code``), gaze 0, the frontal camera."""
        items = []
        for i in range(nums):
            tv = 1.0 - (i / (nums - 1))
            sc = codes_1["shape_code"] * tv + codes_2["shape_code"] * (1 - tv)
            ac = codes_1["appea_code"] * tv + codes_2["appea_code"] * (1 - tv)
            items.append((sc, ac, np.zeros((1, 2), np.float32), self.base_cam))
        return self._run(model, items)


def save_gif(path: str, frames: Sequence[np.ndarray], duration: float = 3.0 / 45) -> None:
    """Write ``frames`` as a looping GIF.  ``duration`` is read as the JAX
    package's GIF writer (imageio's Pillow plugin) reads it, in
    milliseconds: its default, 3/45, makes a delay of 0 hundredths of a
    second, which is what the JAX package's files carry (read back with
    PIL, every frame's ``duration`` is 0; a viewer then shows the frames
    at its own default rate)."""
    write_gif(path, frames, delay_cs=int(round(duration / 10.0)))
