"""The 3DGUT configurations on the program: the trainer with `with_ut` and
`with_eval3d` through a distorting pinhole, for a "train" mix.

The session is the 3DGS one (models/gs3d.py) with the 3DGUT reference step
(reference/train_gut.py, the same MCMC noise), its own work count (the live
pairs of the ray composite, work/eval3d.py), and the control one precision
below the configuration's float32 payload: bfloat16.
"""

from __future__ import annotations

import torch

from ..reference import gut3d, train_gut
from .gs3d import TrainSession as _TrainSession3D
from .gs3d import _render_kw


def open_session(cfg: dict, mix: dict, check: dict, seed: int, device, traced: bool = False):
    if mix["kind"] == "train":
        return TrainSession(cfg, mix, check, seed, device)
    raise ValueError(f"the 3DGUT configurations take train mixes, not {mix['kind']!r}")


class TrainSession(_TrainSession3D):
    control_payload = (torch.bfloat16, torch.bfloat16)
    reference_step = staticmethod(train_gut.train_step)

    def __init__(self, cfg: dict, mix: dict, check: dict, seed: int, device):
        if cfg["render_mode"] != "RGB":  # the trainer's colour render, which the reference follows
            raise ValueError(f"the 3DGUT trainer renders RGB, not {cfg['render_mode']!r}")
        super().__init__(cfg, mix, check, seed, device)

    def _radial(self):
        return tuple(self.cfg["trainer"]["radial_coeffs"])

    def _hyper(self) -> train_gut.Hyper:
        t, m, sf = self.cfg["trainer"], self.mix, self.cfg["strategy_fields"]
        return train_gut.Hyper(self._lrs(), t["max_steps"], t["ssim_lambda"], t["opacity_reg"],
                               t["scale_reg"], sf["noise_lr"], sf["noise_opacity_t"],
                               sf["noise_opacity_k"], self.cfg["sh_degree"],
                               _render_kw(self.cfg, train=True), m["width"], m["height"],
                               self._radial())

    def count(self, params, viewmat) -> dict:
        _, _, live, vis = gut3d.render(params, viewmat, self.cams.K, self._radial(),
                                       self.mix["width"], self.mix["height"],
                                       _render_kw(self.cfg, True), self.cfg["sh_degree"])
        return dict(model="3dgut", live=live, visible=vis, channels=3)
