"""The 2DGS configurations on the program: Trainer2DGS for a "train" mix.

The session is the 3DGS one (models/gs3d.py) with the surfel trainer, its
reference step (reference/train2d.py, the default strategy between
refinements draws nothing), its own work count, and the control one
precision below the configuration's float32 payload: bfloat16.
"""

from __future__ import annotations

import torch

from ..reference import surfel2d, train2d
from .gs3d import TrainSession as _TrainSession3D
from .gs3d import _render_kw


def open_session(cfg: dict, mix: dict, check: dict, seed: int, device, traced: bool = False):
    if mix["kind"] == "train":
        return TrainSession(cfg, mix, check, seed, device)
    raise ValueError(f"the 2DGS configurations take train mixes, not {mix['kind']!r}")


class TrainSession(_TrainSession3D):
    control_payload = (torch.bfloat16, torch.bfloat16)
    reference_step = staticmethod(train2d.train_step)

    @staticmethod
    def trainer_classes():
        from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS

        return Config2DGS, Trainer2DGS

    def _hyper(self) -> train2d.Hyper:
        t, m = self.cfg["trainer"], self.mix
        return train2d.Hyper(self._lrs(), t["max_steps"], t["ssim_lambda"], t["normal_lambda"],
                             t["dist_lambda"], t["normal_start_iter"], t["dist_start_iter"],
                             self.cfg["sh_degree"], _render_kw(self.cfg, train=True), m["width"],
                             m["height"], self.check["facing_min_cos"])

    def _check_rows(self, params):
        """`facing`: the rows that the first checked step's view sees at
        least `facing_min_cos` from edge-on, on the reference's projection
        of the scene as made (the reference's own rows in that step)."""
        W, H = self.mix["width"], self.mix["height"]
        vm = self.cams.viewmats[self.order[0]]
        with torch.no_grad():
            p = surfel2d.project(params["means"], params["quats"], torch.exp(params["scales"]),
                                 vm, self.cams.K, W, H, self.cfg["near_plane"],
                                 self.cfg["far_plane"])
            return {"facing": surfel2d.facing(params["means"], p, vm,
                                              self.check["facing_min_cos"])}

    def _noise(self):
        return None

    def count(self, params, viewmat) -> dict:
        W, H = self.mix["width"], self.mix["height"]
        with torch.no_grad():
            v = surfel2d.view(params, viewmat, self.cams.K, W, H, _render_kw(self.cfg, True),
                              self.cfg["sh_degree"])
            _, live = surfel2d.composite(v.fields, v.bins, W, H)
        return dict(model="2dgs", live=live, visible=int(v.proj.visible.sum()), channels=4)
