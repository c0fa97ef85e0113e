"""Calibrated RGBD views rendered by raytracing an SPC.

Counterpart of ``kaolin_tpu/ops/spc/raytraced_spc_dataset.py``: for each
viewpoint, trace the octree, keep the first hits, and return the frame
tuple (image, depth, camera, intrinsics, ...) that ``bf_recon`` consumes.
Tensors stand where the JAX package returns arrays, on the octree's device;
the scalars are the same Python values.
"""

import numpy as np
import torch

from kaolin_tpu_torch.ops.spc.points import host, morton_to_points
from kaolin_tpu_torch.ops.spc.spc import generate_points, scan_octrees

__all__ = ["RayTracedSPCDataset"]


class RayTracedSPCDataset:
    """Ray intersections of predefined viewpoints with an SPC octree.

    ``__getitem__`` returns (image (H, W, 3) f32, depthmap (H, W) f32, Cam
    (4, 4) world → pixel row-vector matrix, In (4, 4) intrinsic matrix,
    max_depth, mip_levels, true_depth, start_level, points (8^start_level,
    3) int32, is_any_ray_hit).
    """

    def __init__(self, viewpoints, gs_octree, res=8):
        self.viewpoints = np.asarray(host(viewpoints), dtype=np.float32)
        self.gs_octree = (gs_octree if isinstance(gs_octree, torch.Tensor)
                          else torch.from_numpy(np.asarray(gs_octree)))
        self.device = self.gs_octree.device
        lengths = torch.tensor([len(self.gs_octree)], dtype=torch.int32)
        self.level, pyramids, self.exsum = scan_octrees(self.gs_octree,
                                                        lengths)
        self.pyramid = pyramids[0]
        self.point_hierarchy = generate_points(self.gs_octree, pyramids,
                                               self.exsum)
        self.carve_camera_fov = 0.644  # radians
        self.max_depth = float(np.finfo(np.float32).max)
        self.mip_levels = 6
        self.start_level = 4
        self.res = res

    def __len__(self):
        return len(self.viewpoints)

    def __getitem__(self, index):
        from kaolin_tpu_torch.render.camera import Camera, generate_rays
        from kaolin_tpu_torch.render.spc.raytrace import (
            mark_pack_boundaries,
            unbatched_raytrace,
        )

        device = self.device
        res = 2 ** self.res
        eye = torch.from_numpy(self.viewpoints[index]).to(device)
        up = torch.tensor([0.0, 0.0, 1.0], device=device)
        at = torch.zeros((3,), device=device)
        if bool(torch.allclose(torch.linalg.cross(up, at - eye),
                               torch.zeros(3, device=device))):
            up = torch.tensor([0.0, 1.0, 0.0], device=device)
        camera = Camera.from_args(eye=eye, at=at, up=up,
                                  fov=self.carve_camera_fov, width=res,
                                  height=res, device=device)
        origins, dirs = generate_rays(camera)
        ridx, _, depths = unbatched_raytrace(
            self.gs_octree, self.point_hierarchy, self.pyramid, self.exsum,
            origins, dirs, self.level, return_depth=True, with_exit=False)
        is_any_ray_hit = ridx.shape[0] > 0
        if not is_any_ray_hit:
            return (None,) * 9 + (False,)

        first = mark_pack_boundaries(ridx)
        first_rays = ridx[first].long()
        image = torch.zeros((res * res, 3), dtype=torch.float32,
                            device=device)
        image[first_rays] = 1.0
        depthmap = torch.full((res * res,), self.max_depth,
                              dtype=torch.float32, device=device)
        depthmap[first_rays] = depths[first, 0]

        cx = float(camera.intrinsics.cx[0])
        cy = float(camera.intrinsics.cy[0])
        fx = float(camera.intrinsics.focal_x[0])
        fy = float(camera.intrinsics.focal_y[0])
        # computer-vision convention: perspective division by z
        intr = torch.tensor([[fx, 0, 0, 0], [0, fy, 0, 0], [cx, cy, 1, 0],
                             [0, 0, 0, 1]], dtype=torch.float32,
                            device=device)
        ex = camera.extrinsics.view_matrix()[0].T
        flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0],
                                       device=device))
        cam_mat = (ex @ flip) @ intr
        points = morton_to_points(
            torch.arange(8 ** self.start_level, device=device)).to(
                torch.int32)
        return (image.reshape(res, res, 3), depthmap.reshape(res, res),
                cam_mat, intr, self.max_depth, self.mip_levels, True,
                self.start_level, points, is_any_ray_hit)
