#!/usr/bin/env python3
"""Run the PyTorch port's fourteen paths on one NVIDIA GPU and check them:
the DIB-R inverse-rendering step, the DIB-R pose-and-texture fit (config 2
as written, ``examples/torch_dibr_texture_fit.py``, with the two ported
camera and bounding-box tutorials), the SPC first-hit raster, config 3 as
written (mesh → SPC at level 9, ``unbatched_raytrace`` at 512² and an
nglod-style fit, ``examples/torch_spc_raytrace.py``), the primitive-cost
probe with its table-gather kernel, the Simplicits sim step (config 1),
Simplicits contact (``bench.py``'s ``collision_10k``) and Simplicits
training, config 1's easy-API path from a closed mesh
(``examples/torch_simplicits_train.py``), and config 4, the FlexiCubes
SDF fit at res 64 in its bench and topology forms
(``examples/torch_flexicubes_sdf.py``), with the DMTet tutorial
(``examples/torch_tutorial_dmtet.py``), and config 5, the simulatable 3D
gaussian splats of ``bench.py``'s ``bench_gaussians_sim``
(``examples/torch_simulatable_gaussians.py``: 2,000 gaussians densified
into a 2,048-point Simplicits body with contact, 100 steps moving the
gaussians by LBS, and the densifier's level-8 carving), and the full
mesh render (``examples/torch_easy_render.py``: a two-material
``SurfaceMesh`` through ``render_mesh`` at 512² under one SG light and
under 32 lobes fitted to an environment map, a 100-step fit through the
render, DefTet at its defaults, and the three lighting and render
tutorials), which launches the winner search once a render, and the
asset from disk (``examples/torch_asset_render.py``: the 81,408-face
asset written as OBJ/MTL/PNG, GLB, PLY and OFF and imported, its OBJ and
GLB imports rendered at 512² through the winner search, 2^20 gaussians
through the 3DGS PLY, a ShapeNetV2 tree through ``CachedDataset`` on
spawned workers, ``GraphConv`` at width, and the meshes tutorial), and
the asset through USD (``examples/torch_usd_asset.py``: the same asset
written and read as ``.usda`` and ``.usdc`` and rendered at 512² through
the winner search, 2^20 gaussians through a ``.usdc``, the full render's
fit logged by ``Timelapse`` and served as dash3d's wire bytes, the
Jupyter turntable's 16 renders, and ``check_sign`` through the native host
library, built by g++). Config 3 as written, the three Simplicits paths,
configs 4 and 5 and the I/O around the asset are plain PyTorch: the JAX
package has no kernel there.

    python3 chip_smoke.py

Imports ``kaolin_tpu_torch`` only (no jax, no ``kaolin_tpu``). Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``kaolin_tpu_torch/**/csrc/*.cu`` (sm_90a);
3. hold each kernel against its plain PyTorch version on the card: winner
   ids exactly, the soft-mask forward within 1e-5, the soft-mask backward
   within 1e-4 of the plain gradient's largest entry (the plain autograd
   sums in another order); at 100x72 with B = 2, at the config-2 shapes,
   on ``adversarial_faces`` (box edges on pixel centres, faces off the
   image, one face over the whole image), on config 2's sphere twice in
   one batch and on 100 faces over a whole 512x512 image (the plan's two
   passes and its larger bands; every tile's face list holds 100 faces);
   the winner and the forward also on 2,000 small faces in one 16x16 tile
   (each of its four 8x8 kernel tiles lists about 500 faces, more than
   the 256 a block stages at once). The forward given the
   rasterizer's ids (``face_idx``) bitwise equal to the forward without
   them at every uncovered pixel and 1.0 at every covered one, and bitwise
   equal across two launches; the backward bitwise equal across two
   launches on config 2. The SPC tile and untile kernels
   bitwise (depths) and exactly (ids), on a clustered level-5 octree at
   64² with 8-px tiles, on config 3 and on a camera inside config 3's
   shell with its grown capacities. The soft-mask backward also on a
   pixel centre 0.001 from an edge (``edge_pixel_faces``), where a
   cotangent there alone gives every face exactly 0 (fault F11); the
   JAX-style positional calls of ``dibr_rasterization`` and
   ``dibr_soft_mask`` equal the plain calls (F12); ``raster_first_hit``
   with 32-px tiles equals 16-px tiles at config 3 (F13);
4. the sim step on the card against the port's CPU step from the CPU's
   states, 10 steps at ``__graft_entry__``'s size and 3 at config 1, the
   displacement B z within 1e-4 of its largest entry (B z does not depend
   on the QR basis of z); TF32 off in every sim phase; contact on the card
   against the CPU: each broad phase's pair set and diagnostics on three
   seeded scenes of 3 x 400 points (grid and sweep equal to dense on both
   devices); at 5 states of the example's stack (2 x 300 points, a
   10 x 10 plate) the detection, the contact terms and the step's energy
   within 1e-4 (``check_stack_step`` says why its step is not held); and
   ``make_demo_scene``'s scene, 10 steps (5 for the sweep) from the CPU's
   states, B z within 1e-4 of max|B z| plus twice the card's own spread;
   the training path's pieces on the card against the CPU: ``check_sign`` of
   the example's torus (4,096 faces) on 100,000 candidates, equal but
   within 1e-5 of an edge or a face (``check_sign_margin``); the losses at
   full width (33 handles, 6 layers, 1,000 samples, batch 10) from one set
   of weights and draws, and 20 Adam steps from one generator, within
   2e-3; FPS bit for bit with inf and NaN rows; the sparse builders within
   1e-5; one step of the texture fit at 512², B = 2, from one seeded state
   and the card's target views, against the same step on the CPU (the
   plain versions): face_idx equal, the soft mask within 1e-5, the loss
   within 1e-5 relative, each parameter's gradient within 1e-4 of its
   largest entry; ``texture_mapping`` card against CPU at the template's
   UVs (the seam at u = 1, the rings at v = 0 and 1); kernel #7 (the
   texture kernels, which replace no TPU kernel) against its plain version
   on the card at the benchmark cells' shapes, with per-view and
   batch-of-one textures, both modes, and its pixel counters; kernel #8
   (the re-gather, which replaces no TPU kernel) against its plain version
   on both DIB-R cells' own data: its output bit for bit, its gradients
   within their float32 sum bound, its launches and pixel counters;
5. the DIB-R path: ``config2_step`` (512², a 4992-face UV sphere, forward
   and backward, 5 steps) with every launch counter set to 0 before and
   read after (each soft-mask forward given the rasterizer's ids), its
   first step held against the same step through the plain versions; then
   the 64² silhouette optimisation of
   ``examples/torch_dibr_optimization.py`` (final loss < 0.30, |shift| <
   0.05); then 100 steps of the texture fit from its start, the counters
   set to 0 before and read after each step: #1-3 launch on every step,
   and #7 and #8 once each way, the losses are finite, the silhouette term falls
   by at least half and the pose error (angle and translation) falls; its
   peak memory; then the
   camera tutorial (256²) and the bounding-box fit (4 views at 128², 153
   Adam steps) at full size, each asserting what its JAX counterpart
   asserts;
6. the SPC path: ``config3_frames`` of ``examples/torch_spc_raster.py``
   (a level-9 sphere shell, 512², 60 frames, capacities grown until no
   overflow), counters set to 0 before and read after; frame 0 held against
   the plain versions and against a brute-force slab test of every leaf on
   4,096 sampled pixels; then a camera inside the shell, whose slot
   overflow must clear as ``s_max`` grows; then config 3 as written:
   the card against the port's CPU at level 7 and 128² (octree, dual,
   trinkets and nugget streams equal, depths within 1e-6, every packed op
   within 1e-6 and its gradient within 1e-5 of max|g|, the nglod render,
   loss and gradients within 1e-5), the path at full width with every
   counter set to 0 before and read after (no kernel may launch; the JAX
   package's 181,068 octree bytes, 519,599 leaves, 700,667 points,
   1,449,015 dual corners and view 0's 841,737 nuggets over 84,399 rays
   with its nine level counts; 50 fit steps, the loss over steps 41-50
   below 0.7 of steps 1-10), and the cross-check: config 3's shell
   through ``unbatched_raytrace`` against #4's depth map (hit masks
   equal, depths within rtol 2e-6 / atol 1e-6, ids equal where the depth
   is bit for bit, at least 75%); then config 4: its modules card vs CPU
   at res 16 on the ellipsoid and a seeded random field with C16/C19
   cubes (``phase_flexi_parity``: the grid, the topology, every face, tet,
   mask and count equal through ``dense_extract``, ``__call__`` with
   weights and features, ``output_tetmesh`` and ``jit_extract``, marching
   tets, marching cubes, cube meshes, MISE, ``ops/voxelgrid`` and the
   metrics, ``sided_distance`` ids among them; floats within 1e-6; the
   gradients in the field and the three weights within 1e-5 of max|g|,
   gamma_f's within that or twice the CPU float32 gradient's own distance
   from float64; the QEF placement within 1e-5 of a float64 solve on the
   CPU, within that or twice the CPU's distance on the card), then the
   path at full width with every counter set to 0 before and read after
   (``phase_flexi_path``: both forms at res 64 for 50 steps, step 1 with
   the JAX package's 9,240 surface cubes, 9,238 quads, 36,952 faces and
   1,810,624 / 3,048,192 dense slots, the loss falling;
   DMTet's 120 steps, the chamfer halved; no kernel may launch; one step
   of each form card vs CPU from the start field; marching cubes of the
   fitted field card = CPU); then config 5 (``phase_gauss_parity``: the
   card against the port's CPU, ``transform_gaussians`` with SH degree 3
   on 2,000 gaussians within 1e-6 of max|x|, ``gs_to_voxelgrid`` coords
   equal and opacities within 1e-9 relative, ``bf_recon`` on
   tests/ops/test_bf_recon.py's fixture bytes and colors equal, the
   densifier with ``jitter=False`` by flood fill and by carving from one
   set of frames, points within 1e-6, the bench scene's step from the
   CPU's states, B z within 1e-4 of max|B z|; ``phase_gauss_path``: the
   bench form at full size, 100 steps eager and from the graph from one
   start with every counter set to 0 before and read after (no kernel may
   launch; finite, flags 0, no resize, the broad phase the auto rule's,
   the renderable mean height falling and staying above the floor, graph
   = eager within 1e-4 of max|z|), one step with the grid forced against
   the auto choice, and the densifier at its defaults (level 8, 86 views
   at 256²): no fallback, the interior filled, every sample inside the
   box; ``phase_gauss_timing`` after phase_flexi_timing); then the full
   render (``phase_render_parity``: the card against the port's CPU, the
   two-material scene at 512² with face_idx equal and every pass within
   1e-5 of its max|x|, one fit step at 256² with its gradients within 1e-4
   of max|g|, DefTet at 128² with knum 300 from one set of inputs with
   face_idx equal and features within 1e-6, the 32-lobe environment fit's
   amplitudes within 1e-4 of the largest, and a mesh whose vertices are
   re-set equal to a fresh mesh within 1e-6 (fault F28);
   ``phase_render_path``: the render and the environment-lit render each
   launch #1 once and #2-6 never, the fit's 100 steps launch #1 on every
   step and its loss halves, DefTet at its defaults at 512² gives depths
   non-increasing along knum, and the three tutorials pass their checks at
   full size; ``phase_render_timing`` after phase_gauss_timing); then the
   asset from disk (``phase_io_parity``: on a small copy of the asset,
   card vs CPU, its OBJ and GLB imports rendered at 64² with face_idx
   equal and every pass within 1e-5 of its max|x|, the OBJ import against
   the same mesh built in memory, GraphConv's forward within 1e-5 and its
   gradients within 1e-4 of max|g|, the 3DGS transform within 1e-6;
   ``phase_io_path``: at full size, the four imports equal what was
   written (the GLB's within 1e-6), both 512² renders launch #1 once and
   #2-6 never, #1's winner ids at each render's shape equal to its plain
   version's on the same CUDA tensors, the OBJ's 512² render against the
   CPU's render of the same file (face_idx equal, passes within 1e-5),
   GraphConv and the seeded generators made on the card by default, the
   2^20-gaussian round
   trip (positions and SH bit for bit, quaternions as the import
   normalizes them, opacities and scales within 1e-6 relative), the
   dataset's 4 spawned workers equal to its serial loop, GraphConv, the
   meshes tutorial; ``phase_io_timing`` after
   phase_render_timing); then the asset through USD
   (``examples/torch_usd_asset.py``; ``phase_usd_parity``: the native
   host library built by g++ from ``kaolin_tpu_torch/native/csrc``, every
   LZ4 block and every native ``check_sign`` of the USD phases counted in
   the library; a small copy of the asset written as ``.usda`` and
   ``.usdc`` from CUDA and from CPU tensors, the files byte-equal, the
   imports equal and rendered at 64² with face_idx equal and passes within
   1e-5 of max|x|; the native ``check_sign`` of the training path's torus
   and 100,000 candidates on the card's tensors against the device's ray
   parity, equal but within 1e-5 of an edge or face;
   ``phase_usd_path``: at full size, the 81,408-face asset with its
   1,024² maps written as ``.usda`` and ``.usdc`` and imported through
   ``io.import_mesh`` (the ``.usdc`` import bit for bit, the ``.usda``
   within ``:g``'s 5e-6 relative, the dispatcher's mesh equal to
   ``io.usd.import_mesh``'s), the ``.usdc`` import's 512² render launching
   #1 once and #2-6 never, face_idx equal to the OBJ import's render of
   the same geometry, #1's winner ids against its plain version on the
   same CUDA tensors; 2^20 gaussians through a ``.usdc`` bit for bit; the
   100-step fit logged by ``Timelapse`` (11 checkpoints; the last equal to
   the fit's vertices within 5e-6 relative; the files and dash3d's wire
   bytes written from the card's tensors equal to those from CPU copies);
   the turntable's 16 renders (#1 16 times, a frame's winner ids against
   the plain version, its cameras within 1e-6 of a CPU visualizer's after
   the same events); ``phase_usd_timing`` after phase_io_timing);
7. the table gather's two routes (shared memory, L2) held bit for bit
   against ``table_gather_plain``: the probe's shape, 2^14 and 2^20
   tables, 58,110 and 58,111 floats (either side of the route rule),
   negative and out-of-range indices, counts that are not a multiple of 4
   or of the L2 route's 1,024-index tile, 2^22 indices, 4,097, a 64 MB
   table and unaligned views; the shared-memory route's edges (tables of
   1, 3, 4, 5 and 1,021 floats and its largest, 1 and 3 indices, fewer
   than one cluster has threads, a grid rounded up to whole clusters with
   a block that gets no index; each launch's cluster size and blocks
   printed); then the camera API without ``device`` on the card
   (``Camera.from_args`` with lists, ``from_lookat`` given an eye on the
   card, the dicts, grids, bases and projection), equal to its CPU build;
8. the probe path: ``primitives_bench.main([])`` at its full sizes, counters
   set to 0 before and read after; every probe printed its line, both
   gather routes launched, and ``correct`` is true; then config 1's 150
   steps eager (Newton stops early) and from a CUDA graph (fixed trip),
   counters set to 0 before and read after (the path has no kernel): the
   mean height falls and stays above the floor, nothing is NaN, no graph
   step runs again eagerly, and the two end within 1e-4 of max|z|; a scene
   with a kinematic object, moved mid-run, graph against eager; their
   steps/s (eager ``run_sim_step``, one graph replay, ``run_sim_steps(150)``
   eager and from the graph) are timed after the kernels, from a graph
   captured after earlier graphs were freed and replayed after their
   memory was filled with NaN (fault F14), held against eager from the same
   start; then ``collision_10k`` at full size (10,712 contact particles,
   the grid): steps and capacity checks until a 20-step window needs no
   resize, then 20 steps eager and 20 from the graph from one start,
   counters set to 0 before and read after (no kernel may launch): finite,
   the flags 0, pairs found, every cube above the floor, no graph step run
   again eagerly, graph against eager within 1e-4 of max|B z|; its steps/s
   (eager ``run_sim_step``, one replay, ``run_sim_steps(20)``); then the
   training path, counters set to 0 before and read after (no kernel may
   launch): the torus's interior from 100,000 candidates (its share within
   2% of the torus's volume share of its box), 1,000 Adam steps at full
   width (the loss falls, the weights are finite), the bake at 1,000 points
   (396 DOFs) and 30 sim steps eager and from the graph (falling, above
   the floor, graph = eager within 1e-4 of max|B z|), ``create_with_rkpm``
   at config 1's points (33 handles, 256 nodes) and 10 steps of it; the
   differentiable step's gradient (graft scene) card vs CPU within 1e-3 of
   max|g|, finite and not zero; the training step's steps/s (steps 100-300
   of one run), ``check_sign``, FPS, ``create_with_rkpm`` and one
   differentiable config-1 step forward and backward; config 4's bench
   step, 50-step run, topology step, topology alone and DMTet step (CUDA
   events, medians of 10, peak memory; their profiles in phase 10); config 3 as
   written: ``unbatched_mesh_to_spc``, the dual and the trinkets, a depth
   frame and a fit step (event ms, device busy, ops, idle share, the
   largest ops, peak memory); config 5's 100-step window eager and from
   the graph (ms/step), its step's and the LBS move's profile and bound,
   the flood-fill densifier at level 6 with gs_to_voxelgrid's share, each
   with its peak memory, and the parts of the level-8 carve that
   phase_gauss_path timed (voxelization, the 86 views, bf_recon, the
   query); the full render at 512² at 4,992 and 81,408 faces, under 32
   environment lobes, the fit step and DefTet at its defaults (CUDA
   events, device busy, idle share, the largest ops and #1's share, peak
   memory, the render's and the step's bounds), and the 81,408-face
   set-up once with #1's winner ids at its shape against the plain
   version; the asset from disk: each format's import on the host
   clock, the 512² renders of the OBJ and GLB
   imports (CUDA events, device busy, idle share, the largest ops and
   #1's share, peak memory), the 2^20-gaussian export, import and
   transform, GraphConv's forward and backward with its bound, and the
   dataset's spawned pool against its serial loop;
9. time each kernel and each path against the plain versions with CUDA
   events, in the order plain, kernel, kernel, plain; the texture fit's
   step event to event over steps 20-80 of one run;
10. ``torch.profiler`` (``kaolin_tpu_torch.utils.profiling.trace``) over 10
   config-2 steps and 10 config-3 frames after warm-up: each kernel's
   device ms and launches per step or frame, each path's device-busy and
   idle share; the gathers, ``table[idx]`` (``library_ms``) and the plain
   versions at the probe's shapes, cold (a 256 MB fill before each call
   evicts L2; the kernels line takes these) and warm; both gather routes
   cold and warm on tables of 2^10 to 58,110 floats, to show where the
   route rule belongs;
   the config-1 sim step and the collision_10k step eager and as a graph
   replay, and one training step: device busy, idle share and the largest
   ops, and detection's share of the collision_10k step; config 4's two
   steps and the DMTet step: device ops, busy, idle share, largest ops
   (the texture fit's
   step, with #1-3's device ms at its shapes, is profiled in its timing
   phase);
11. each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
   and its float32 operations over 67 TFLOP/s (H100 SXM data sheet), the
   operations counted from this run's inputs, a term that depends on the
   face alone once per face, for the soft-mask forward only the pairs at
   pixels the rasterizer leaves uncovered (beside the all-pixel count),
   and for the SPC tile kernel only the slab
   tests the walk needs (every unit box walked, the leaves of the units a
   ray enters nearer than its best, the level-3 boxes); then the kernels
   in the order in which to make them faster; and the config-1 sim step's
   bound, its dense products and factorizations over 67 TFLOP/s, at the
   graph's 5 Newton iterations and at the eager path's measured count; the
   collision_10k step's, the same products object by object plus the
   contact terms at this run's contact count and the grid's pair tests;
   the training step's, its MLP rows' and LBS products over 67 TFLOP/s.

Prints a JSON line with each kernel's launches, error, times and bound, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, without
that line, when there is no CUDA device or any phase fails.
"""

import contextlib
import copy
import importlib.util
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 512
STEPS = 5
# config 3: level, resolution, frames; pixels of the brute-force check
SPC_LEVEL = 9
SPC_RES = 512
SPC_FRAMES = 60
ORACLE_PIXELS = 4096
INSIDE_EYE = (0.05, 0.02, 0.04)
# the table gather at the TPU probe's shape: (8192, 128) int32 indices into a
# 2^20-float table (L2 route) and into a 2^14-float one (shared memory)
GATHER_IDX = (8192, 128)
GATHER_TABLES = {"table_gather_l2": 1 << 20, "table_gather_smem": 1 << 14}
# tables up to the shared-memory route's largest, both routes timed on each
GATHER_SWEEP = (1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 40_000,
                58_110)
# cold readings: a 256 MB scratch filled before each profiled launch evicts
# the 50 MB L2; the median over the COLD_REPS launches the trace holds
# whole, at least COLD_MIN of them. A random 4-byte read pulls one
# L2_SECTOR-byte sector.
FLUSH_BYTES = 256 << 20
COLD_REPS = 40
COLD_MIN = 20
L2_SECTOR = 32
PROFILE_STEPS = 10
# the Simplicits sim step: states compared per step at the graft size and
# at config 1; B z within SIM_Z_TOL of max|B z| (card against CPU), z
# within SIM_Z_TOL of max|z| (graph against eager)
SIM_PARITY_STEPS = {"graft": 10, "config1": 3}
SIM_Z_TOL = 1e-4
SIM_TIMED_STEPS = 30
# contact: three seeded scenes of 3 x 400 points for the broad phases; the
# example's stack at 2 x 300 points over a 10 x 10 plate (5 states) and
# make_demo_scene's scene (10 steps a broad phase, 5 for the sweep) for the
# step; collision_10k at full size for 20 steps eager and 20 from the graph
COLLISION_SEEDS = (0, 1, 2)
COLLISION_STACK = dict(objects=2, qp=300, plate_side=10)
COLLISION_PARITY_STEPS = 5
COLLISION_DEMO = dict(num_qp=48, kinematic_qp=25, max_contact_pairs=512)
COLLISION_DEMO_STEPS = {"dense": 10, "grid": 10, "sweep": 5}
# the demo scene padded as a heterogeneous scene batch pads it: the soft
# body to 80 points and 5 handles, the plate to 36 points (43 phantoms)
COLLISION_DEMO_PAD = (80, 5, 36)
COLLISION_STEPS = 20
COLLISION_TIMED_STEPS = 10
COLLISION_PROFILE_STEPS = 4
# the training path (``examples/torch_simplicits_train.py`` at full width)
TRAIN_PARITY_STEPS = 20
TRAIN_LOSS_RTOL = 2e-3
TRAIN_PATH_STEPS = 1000
TRAIN_SIM_STEPS = 30
TRAIN_TIMED = (100, 300)
RKPM_CASE = dict(handles=33, nodes=256, steps=10)
INTERIOR_TOL = 0.02
CHECK_SIGN_MARGIN = 1e-5
GRAD_TOL = 1e-3
TEXFIT_PATH_STEPS = 100
TEXFIT_TIMED = (20, 80)
TEXFIT_GRAD_TOL = 1e-4
# the texture kernels' cases: the benchmark's 8 views at 512², and the side
# of each cell's one texture (texfit.v8 256², asset.v8 1,024²)
TEXTURE_VIEWS = 8
TEXTURE_SIDES = {"texfit.v8": 256, "asset.v8": 1024}
# the kernels against their plain version on the card: the samples round op
# for op as the plain version's (both without contraction), so within 1e-6
# and in fact equal; the UVs' gradient, a sum over one pixel's own taps and
# channels with no atomics, within 1e-5 of its largest entry (the kernel
# sums them in another order). The texture's gradient adds by atomics in no
# fixed order on both sides, so each entry is held to the float64 sum of
# the same float32 products: the reference samples the float32 UVs with
# only the texture and the cotangent in float64, so it picks the same taps
# and weights. A float32 sum of n products, in any order, is within
# (n + 1) x 2^-24 of the sum of their magnitudes; the plain version's
# per-view sums and the views' sum after them stay within (n + B) x 2^-24
# for B views. Each entry of both is held to (n + B + 2) x 2^-24 of its
# terms' magnitudes (the float64 sum's own rounding is 2^-29 of that): one
# pixel's add dropped, doubled or sent to another texel is thousands of
# times that far off on a texel of tens of adds
TEXTURE_VALUE_TOL, TEXTURE_UV_GRAD_TOL = 1e-6, 1e-5
TEXTURE_SUM_ULP = 2.0 ** -24
# kernel #8 against its plain version on the card, on each DIB-R cell's own
# data after REGATHER_STEPS steps of the fit: the forward rounds op for op
# as the plain version (both without contraction), so bit for bit. Each
# gradient entry is a float32 sum of n per-pixel terms in an order that
# changes from launch to launch, held to the float64 sum of the same terms
# (chip_smoke.regather_bwd_rule from the float32 barycentrics both sides
# share): a sum of n terms in any order is within (n + 1) x 2^-24 of the
# sum of their magnitudes. A feature term is one float32 product, exact to
# 2^-24; a coordinate term is itself a float32 evaluation of D + 9 steps
# (the D products and sums against the features, the divisions by the
# norm, the two products and the difference), within (D + 9) x 2^-24 of
# the same evaluation on magnitudes. So each entry within
# (n + REGATHER_CHAIN + D) x 2^-24 of its terms' magnitudes, for both the
# kernel and the plain version, whose autograd sums the same terms in its
# own order
REGATHER_STEPS = 10
REGATHER_CHAIN = 12
REGATHER_SEED = 2147483999
SPCRT_PARITY = (7, 128)          # level, resolution of card vs CPU
SPCRT_LEVEL = 9
SPCRT_RES = 512
SPCRT_STEPS = 50
SPCRT_TIMED = 10
SPCRT_LOSS_RATIO = 0.7
# config 3 as written at full width, as the JAX package gives it
SPCRT_EXPECT = {"octree_bytes": 181_068, "leaves": 519_599,
                "points": 700_667, "dual_corners": 1_449_015,
                "nuggets": 841_737, "rays_hit": 84_399,
                "level_counts": [731_372, 950_135, 933_916, 890_255, 917_359,
                                 901_514, 893_800, 874_263, 841_737]}
# a gradient card vs CPU within 1e-5 of max|g|. Two (SPCRT_SUMS) take 1e-5
# or 0.1 of the CPU float32 gradient's own distance from float64, whichever
# is larger: the card's expf parts from the CPU's exp by an ulp, which
# alpha = 1 − exp(−τ) at τ ~ 6e-3 and then the residual I − I* magnify to
# ~1e-5 there. With the render's exp taken on the CPU every gradient is
# held to 1e-5; the float64 step from the same nuggets to 1e-10, the
# replayed sums to 1e-6 (nglod_sources)
SPCRT_TOL = {"t": 1e-6, "rel": 1e-6, "grad": 1e-5, "own": 0.1, "f64": 1e-10,
             "replay": 1e-6}
SPCRT_SUMS = ("features", "w0")
FLEXI_PARITY_RES = 16           # config 4 card vs CPU
FLEXI_RES = 64
FLEXI_STEPS = 50
FLEXI_TIMED = 10
# the JAX package's integers at step 1 of config 4 from its start field
FLEXI_EXPECT = {"surf_cubes": 9240, "dual_vertices": 9240, "quads": 9238,
                "faces": 36952, "vertex_slots": 1_810_624,
                "face_slots": 3_048_192}
FLEXI_TOL = {"float": 1e-6, "grad": 1e-5, "loss": 1e-5, "qef": 1e-5,
             "own": 2.0, "f64": 1e-10}
GAUSS_PARITY_STEPS = 3         # config 5 card vs CPU
GAUSS_TOL = {"transform": 1e-6, "opacity": 1e-9, "points": 1e-6, "z": 1e-4}
GAUSS_BF_VIEWS = np.array([      # tests/ops/test_bf_recon.py's
    [6.0, 0.0, 0.9], [-6.0, 0.0, 0.9], [0.0, 6.0, 0.9],
    [0.0, -6.0, 0.9], [0.9, 0.9, 6.0], [0.9, 0.9, -6.0]], dtype=np.float32)
GAUSS_CARVE_VIEWS = np.array([   # tests/ops/test_gaussians.py's
    [4.0, 0, 0.3], [-4.0, 0, 0.3], [0, 4.0, 0.3], [0, -4.0, 0.3],
    [0.3, 0.3, 4.0], [0.3, 0.3, -4.0],
    [2.3, 2.3, 2.3], [-2.3, -2.3, -2.3]], dtype=np.float32)
RENDER_RES = 512                 # the full render (examples/torch_easy_render.py)
RENDER_STEPS = 100
RENDER_TIMED = 10
RENDER_GRAD_RES = 256            # one fit step card vs CPU
RENDER_DEFTET_PARITY = 128       # DefTet card vs CPU, knum 300
RENDER_TOL = {"pass": 1e-5, "grad": 1e-4, "feature": 1e-6, "env": 1e-4}
# float32 operations a covered pixel of the render does, counted from its
# formulas for one SG light: the re-gather's barycentrics and 8 feature
# channels (60), the UVs' remainder and the normals' sign (5), both
# materials' bilinear samples of 7 texture channels (114), the bitangent
# and the normal map (43), the material blends (24), the normalization and
# view ray (23), the diffuse inner product (35) and the specular term (125)
RENDER_PIXEL_OPS = 430
ENV_LOBE_OPS = 70                # each further lobe: its two inner products
ADAM_OPS = 12                    # a parameter's Adam update
# the asset from disk (examples/torch_asset_render.py); card vs CPU on a
# small copy of it
IO_PARITY = dict(asset=(40, 64), tex=128, res=64, gaussians=4096)
IO_TOL = {"pass": 1e-5, "gcn": 1e-5, "gcn_grad": 1e-4, "glb": 1e-6,
          "gauss": 1e-6, "act": 1e-6}
IO_TIMED = 10
# the asset through USD (examples/torch_usd_asset.py): card vs CPU on a
# small copy; :g keeps 6 significant digits
USD_PARITY = dict(asset=(24, 32), tex=64, res=64)
USD_TOL = {"usda": 5e-6, "pass": 1e-5, "camera": 1e-6}
USD_TIMED = 10
TRACE_DIR = os.path.join(ROOT, "build", "traces")
# the plane's body +z rotated onto +y (up_axis y)
NEWTON_Q_UP_Y = (-float(np.sin(np.pi / 4)), 0.0, 0.0,
                 float(np.cos(np.pi / 4)))
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# float32 operations per unit of work, counted from the plain versions:
# rasterization._barycentrics per (pixel, face) pair in the closed box (9
# subtractions, 6 products, 3 additions, 3 divisions)
WINNER_OPS = 21
# dibr._edge_vertex_sqdist, each term counted once where it is first needed
# and each shared subexpression once. Per face, what depends on the face
# alone: an edge's A, B (1 each), C (3), A·A, B·B, A·B, A·C, B·C (1 each)
# and A·A + B·B + EPS (2), 12 x 3 edges; the box, 8 min/max and 4 for the
# margin
SOFT_FACE_OPS = 3 * 12 + 12
# per (pixel, face) pair in the enlarged box: an edge's up (4), x3 and y3
# (4 and a division each), direct (7), perp = up·up / den (2) and the
# compare (1), 24 x 3 edges; a vertex's squared distance, 5 x 3; the least
# of 6 candidates, 5; p = exp(c·d2) with c = -sigmainv / mult² once a call
# (2), 1 - p and the product (2)
SOFT_FWD_OPS = 3 * 24 + 3 * 5 + 5 + 2 + 2
# the backward recomputes the forward up to p (94), then its VJP at the
# least: 1 - p (1), the tie count (6 compares, 5 additions), the cotangent
# g·(k·p) / ((1 - p)·ties) (4), and the cheapest candidate's VJP, a vertex's
# (5: -2c, its products with dx and dy, their sums into the face gradient)
SOFT_BWD_OPS = SOFT_FWD_OPS - 2 + 1 + 11 + 4 + 5
# raster._slab per (pixel, leaf) test: 6 subtractions, 6 products, 6
# min/max per axis pair, 4 for entry and exit, the clamp and the compare
SLAB_OPS = 24

KERNELS = {
    "winner": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/rasterize.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_rasterize.py:37",
    },
    "soft_mask_fwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:180",
    },
    "soft_mask_bwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:207",
    },
    "spc_raster": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/spc/csrc/raster.cu",
        "replaces": "kaolin_tpu/render/spc/raster.py:324",
    },
    "spc_untile": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/spc/csrc/raster.cu",
        "replaces": "kaolin_tpu/render/spc/raster.py:614",
    },
    "table_gather_smem": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/utils/csrc/gather.cu",
        "replaces": "kaolin_tpu/utils/primitives_bench.py:135",
    },
    "table_gather_l2": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/utils/csrc/gather.cu",
        "replaces": "kaolin_tpu/utils/primitives_bench.py:135",
    },
    # kernel #7 replaces no TPU kernel: the JAX package samples textures
    # with four plain gathers (no pallas_call)
    "texture_fwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/texture.cu",
        "replaces": "none (kaolin_tpu/render/mesh/utils.py:_grid_sample_2d)",
    },
    "texture_bwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/texture.cu",
        "replaces": "none (kaolin_tpu/render/mesh/utils.py:_grid_sample_2d)",
    },
    # kernel #8 replaces no TPU kernel: the JAX package re-gathers the
    # winners with one take_along_axis (no pallas_call)
    "regather_fwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/regather.cu",
        "replaces": "none (kaolin_tpu/render/mesh/rasterization.py:359)",
    },
    "regather_bwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/regather.cu",
        "replaces": "none (kaolin_tpu/render/mesh/rasterization.py:359)",
    },
}
DIBR_KERNELS = ("winner", "soft_mask_fwd", "soft_mask_bwd")
TEXTURE_KERNELS = ("texture_fwd", "texture_bwd")
REGATHER_KERNELS = ("regather_fwd", "regather_bwd")
# the texture maps of a material that easy_render's ``tex_sample`` samples,
# each through one #7 forward a render
SAMPLED_MAPS = ("normals_texture", "diffuse_texture", "specular_texture",
                "metallic_texture", "roughness_texture")
SPC_KERNELS = ("spc_raster", "spc_untile")
GATHER_KERNELS = ("table_gather_smem", "table_gather_l2")
# the kernels' names in a torch.profiler trace: the kernel whose launches
# are counted, then the helper launches whose time is the kernel's too
DEVICE_NAMES = {"winner": ("winner_kernel", "winner_box_kernel"),
                "soft_mask_fwd": ("soft_fwd_kernel", "soft_fwd_box_kernel"),
                "soft_mask_bwd": ("soft_bwd_kernel", "soft_bwd_count_kernel",
                                  "soft_bwd_plan_kernel",
                                  "soft_bwd_sum_kernel"),
                "spc_raster": ("raster_tiles_kernel",),
                "spc_untile": ("untile_kernel",),
                "table_gather_smem": ("gather_smem_kernel",),
                "table_gather_l2": ("gather_l2_kernel",),
                "texture_fwd": ("texture_fwd_kernel",),
                "texture_bwd": ("texture_bwd_kernel", "texture_zero_kernel"),
                "regather_fwd": ("regather_fwd_kernel",),
                "regather_bwd": ("regather_bwd_kernel",
                                 "regather_zero_kernel")}
# every line the full probe prints, in order
PROBE_NAMES = (
    "gather1d_n65536_tab1048576", "gather1d_n1048576_tab1048576",
    "gather1d_n4194304_tab1048576", "gather1d_n4194304_tab16384",
    "rowgather_r8_n262144", "rowgather_r64_n262144", "scatter_add_n1048576",
    "scatter_min_n1048576", "scatter_set_unique_n1048576", "sort_kv_n262144",
    "sort_kv_n1048576", "sort_kv_n4194304", "rowsort128_r262144",
    "cumsum_n4194304", "table_gather_n1048576_tab1048576",
    "table_gather_n1048576_tab16384")
ENTRY_KEYS = ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms",
              "bound_by", "library_ms")


def adversarial_faces():
    """Scaled faces (2, 36, 3, 2) float32 at 72x100 for the soft mask with
    multiplier 1000 and boxlen 0.02 (margin 20), and a seeded cotangent on
    allprob (2, 72, 100): per batch element 24 random faces, some partly
    off the image; 6 whose enlarged boxes have all four edges on pixel
    centres (the half-open test keeps the low edges and drops the high
    ones); 2 wholly off the image, 2 across its left and bottom edges; a
    point face on a pixel centre (tied candidates); and one face whose box
    covers the whole image (7,200 pixels, more than one band of the
    backward kernel)."""
    h, w, margin = 72, 100, np.float32(20.0)
    sx, sy = np.float32(1000.0 / w), np.float32(1000.0 / h)

    def cx(c):   # pixel centres as rasterization._pixel_coords rounds them
        return sx * np.float32(2 * c + 1 - w)

    def cy(r):
        return sy * np.float32(h - 2 * r - 1)

    def vertex(centre, sign):
        """A float32 v with fl(v - sign * margin) == centre exactly."""
        v = np.float32(centre + sign * margin)
        for _ in range(8):
            e = np.float32(v - sign * margin)
            if e == centre:
                return v
            v = np.nextafter(v, np.float32(np.inf if e < centre else -np.inf),
                             dtype=np.float32)
        raise AssertionError(f"no vertex puts an edge on {centre}")

    rng = np.random.RandomState(7)
    out = []
    for _ in range(2):
        faces = list(rng.randn(24, 3, 2).astype(np.float32) * 400)
        for _ in range(6):
            c, r = rng.randint(2, w - 12), rng.randint(2, h - 12)
            x0, x1 = vertex(cx(c), 1), vertex(cx(c + rng.randint(3, 9)), -1)
            y1, y0 = vertex(cy(r), -1), vertex(cy(r + rng.randint(3, 9)), 1)
            faces.append([[x0, y0], [x1, (y0 + y1) / 2], [(x0 + x1) / 2, y1]])
        faces += [[[1200, 100], [1400, 300], [1300, 500]],
                  [[-200, -1100], [300, -1300], [0, -1500]],
                  [[-1100, 0], [-900, 200], [-1050, 300]],
                  [[-100, -1050], [200, -900], [50, -1200]],
                  [[cx(40), cy(20)]] * 3,
                  [[-1100, -1100], [1100, -1050], [-1050, 1100]]]
        out.append(np.asarray(faces, np.float32))
    g = rng.randn(2, h, w).astype(np.float32)
    return np.stack(out), g, h, w


# the soft mask of edge_pixel_faces: a wide falloff, so that faces far from
# a pixel still weigh on it
EDGE_SIGMAINV, EDGE_BOXLEN = 70.0, 0.5


def edge_pixel_faces():
    """Scaled faces (1, 6, 3, 2) float32 at 16x16 for the soft mask with
    multiplier 1000 and ``EDGE_SIGMAINV``/``EDGE_BOXLEN``, a seeded
    cotangent on allprob (1, 16, 16) and the pixel (row, col) = (8, 8),
    whose centre (62.5, -62.5) lies 0.001 below the first face's lower
    edge: that face's d² is 1e-6, its p rounds to 1 and allprob there is 0,
    while d²'s gradient is not 0. The other five faces are seeded and
    overlap the pixel."""
    y = np.float32(-62.5 + 0.001)
    rng = np.random.RandomState(12)
    faces = [[[-237.5, y], [362.5, y], [62.5, 337.5]]]
    faces += list(rng.uniform(-700, 700, (5, 3, 2)))
    g = rng.randn(1, 16, 16).astype(np.float32)
    return np.asarray(faces, np.float32)[None], g, 16, 16, (8, 8)


def with_depth(fvi, seed):
    """Seeded z (B, F, 3) in [-3, -1] and a validity mask (B, F) with about
    one face in five culled, for the winner search on faces ``fvi``."""
    rng = np.random.RandomState(seed)
    b, f = fvi.shape[:2]
    return {"fvi": fvi,
            "fvz": rng.uniform(-3, -1, (b, f, 3)).astype(np.float32),
            "valid": rng.rand(b, f) > 0.2}


def dense_tile_faces():
    """2,000 small faces inside the top-left 16x16 tile of a 64x64 image and
    48 over the rest, scaled as for multiplier 1000, with z and validity:
    the face lists of its four 8x8 kernel tiles span several chunks and
    are run more than once."""
    rng = np.random.RandomState(5)
    # the tile's pixel centres span x in [-984.4, -515.6], y in [515.6, 984.4]
    c = np.concatenate([rng.uniform([-960, 540], [-540, 960], (2000, 2)),
                        rng.uniform(-1000, 1000, (48, 2))])
    fvi = c[:, None] + rng.uniform(-20, 20, (2048, 3, 2))
    return with_depth(fvi[None].astype(np.float32), 6), 64, 64


def regather_bwd_rule(face_idx, scaled, features, grad_out, multiplier, eps,
                      need_scaled=True, need_features=True, dtype=None,
                      absolute=False):
    """Kernel #8's backward (``regather_bwd_kernel``) in plain PyTorch →
    (grad_scaled (B, F, 3, 2) or None, grad_features (B, F, 3, D) or None).

    A missed pixel, and a hit whose ``grad_out`` is 0 in every channel, add
    nothing; every other pixel's coordinate and feature gradients come
    from its barycentrics in the inputs' precision, rounded as the forward
    rounds them, and then in ``dtype`` (the inputs' where None), summed by
    ``index_add_``. ``absolute``: each gradient with every term taken by
    its magnitude (the sum of the magnitudes of the products at each
    step), the scale of a rounding bound."""
    import torch

    from kaolin_tpu_torch.render.mesh.rasterization import _pixel_coords

    b, h, w = face_idx.shape
    f, d = scaled.shape[1], features.shape[-1]
    dtype = dtype or scaled.dtype
    g = grad_out.reshape(b, h * w, d)
    ids = face_idx.reshape(b, h * w).long()
    bi, pi = torch.nonzero((ids >= 0) & (g != 0).any(-1), as_tuple=True)
    fi = ids[bi, pi]
    v = scaled[bi, fi]                                        # (n, 3, 2)
    px, py = _pixel_coords(h, w, multiplier, scaled.dtype, scaled.device)
    px, py = px.reshape(-1)[pi], py.reshape(-1)[pi]
    ax, ay = v[:, 0, 0] - px, v[:, 0, 1] - py
    bx, by = v[:, 1, 0] - px, v[:, 1, 1] - py
    cx, cy = v[:, 2, 0] - px, v[:, 2, 1] - py
    norm = ((bx * cy - by * cx) + (cx * ay - cy * ax)) + (ax * by - ay * bx)
    norm = norm + torch.where(norm >= 0, eps, -eps)
    wk = torch.stack([bx * cy - by * cx, cx * ay - cy * ax,
                      ax * by - ay * bx], -1) / norm[:, None]   # (n, 3)
    fe, gg = features[bi, fi].to(dtype), g[bi, pi].to(dtype)
    ax, ay, bx, by, cx, cy, norm, wk = (t.to(dtype) for t in (
        ax, ay, bx, by, cx, cy, norm, wk))
    if absolute:
        fe, gg, wk, norm = fe.abs(), gg.abs(), wk.abs(), norm.abs()
        ax, ay, bx, by, cx, cy = (t.abs() for t in (ax, ay, bx, by, cx, cy))

    def minus(x, y):
        return x + y if absolute else x - y

    rows = bi * f + fi
    grad_scaled = grad_features = None
    if need_scaled:
        gw = (gg[:, None, :] * fe).sum(-1)                    # (n, 3)
        gnorm = (gw * wk).sum(-1) / norm
        gW = gw / norm[:, None] + (gnorm if absolute else -gnorm)[:, None]
        g0, g1, g2 = gW.unbind(-1)
        terms = torch.stack([minus(g2 * by, g1 * cy), minus(g1 * cx, g2 * bx),
                             minus(g0 * cy, g2 * ay), minus(g2 * ax, g0 * cx),
                             minus(g1 * ay, g0 * by), minus(g0 * bx, g1 * ax)],
                            -1)
        grad_scaled = torch.zeros((b * f, 6), dtype=dtype,
                                  device=scaled.device)
        grad_scaled.index_add_(0, rows, terms)
        grad_scaled = grad_scaled.reshape(b, f, 3, 2)
    if need_features:
        terms = (wk[:, :, None] * gg[:, None, :]).reshape(-1, 3 * d)
        grad_features = torch.zeros((b * f, 3 * d), dtype=dtype,
                                    device=scaled.device)
        grad_features.index_add_(0, rows, terms)
        grad_features = grad_features.reshape(b, f, 3, d)
    return grad_scaled, grad_features


def dense_step_ops(d, n, m):
    """A Newton iteration's float32 operations in a one-object sim step of
    D dofs, N points and m line-search steps (``Smoke.sim_bound``'s count)
    → (gradient, Hessian, solves, line search)."""
    k = 2 * m + 2
    grad = 4 * 2 * 12 * n * d + 2 * d * d
    hess = 2 * 2 * 12 * n * d + 2 * n * d * (9 + 81) \
        + 2 * d * d * 12 * n + 3 * d * d
    solve = d ** 3 / 3 + 2 * d ** 3 / 3 + 4 * 2 * d * d
    search = 2 * d * d + 2 * (k - 1) * d * d + k * (2 * 12 * n * d
                                                   + 2 * d * d)
    return grad, hess, solve, search


def fmt_ms(ms, spec=".4f"):
    """A device ms as printed, or "not measured" where it is None."""
    return "not measured" if ms is None else format(ms, spec)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def load_example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blob_points(seed=1, level=5):
    """The clustered random octree of tests/render/test_spc_raster.py: four
    blobs of 300 points and 100 points of dust, quantized at ``level``."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.6, 0.6, (4, 3)).astype(np.float32)
    pts = np.concatenate(
        [c + 0.12 * rng.randn(300, 3).astype(np.float32) for c in centers]
        + [rng.uniform(-1, 1, (100, 3)).astype(np.float32)])
    grid = 2 ** level
    return np.unique(np.clip(((pts + 1) * 0.5 * grid).astype(np.int64), 0,
                             grid - 1), axis=0).astype(np.int16)


def contact_clouds(seed, n_per_obj=400, n_obj=3, spread=0.6):
    """``n_obj`` seeded clouds of ``n_per_obj`` points (side 0.6, centres
    in a box of side 2 * ``spread``) and a seeded displacement → (dx, x0,
    obj_ids), float32 and int32: the scenes of the broad-phase parity."""
    rng = np.random.RandomState(seed)
    pts, ids = [], []
    for o in range(n_obj):
        center = rng.uniform(-spread, spread, (3,))
        pts.append(center + rng.uniform(-0.3, 0.3, (n_per_obj, 3)))
        ids.append(np.full(n_per_obj, o))
    x0 = np.concatenate(pts).astype(np.float32)
    dx = rng.uniform(-0.05, 0.05, x0.shape).astype(np.float32)
    return dx, x0, np.concatenate(ids).astype(np.int32)


def pair_set(contacts):
    """The unordered valid pairs of a contact buffer."""
    c = contacts
    keep = c.valid.cpu().numpy()
    ia = c.indices_a.cpu().numpy()[keep]
    ib = c.indices_b.cpu().numpy()[keep]
    return set(zip(np.minimum(ia, ib).tolist(), np.maximum(ia, ib).tolist()))


def check_sign_margin(verts, faces, pts):
    """How near each point (numpy) is to changing ``check_sign``'s answer,
    in its normalized units (the mesh's largest box side is 1), in float64:
    the least of its +z ray's xy distance to any face's edge and, over the
    faces whose xy triangle holds it, |z of the face − z of the point|.
    Rounding can part two devices' answers only at a small margin."""
    v = np.asarray(verts, np.float64)
    scale = (v.max(0) - v.min(0)).max()
    tri = v[np.asarray(faces)] / scale                        # (F, 3, 3)
    a, b = tri[:, :, :2], tri[:, [1, 2, 0], :2]               # edges a → b
    ab = b - a
    out = []
    for q in np.asarray(pts, np.float64) / scale:
        aq = q[:2] - a
        s = np.clip((aq * ab).sum(-1) / np.maximum((ab * ab).sum(-1),
                                                    1e-300), 0.0, 1.0)
        edge = np.linalg.norm(aq - s[..., None] * ab, axis=-1).min()
        e = ab[..., 0] * aq[..., 1] - ab[..., 1] * aq[..., 0]  # (F, 3)
        inside = (e > 0).all(1) | (e < 0).all(1)
        area = e.sum(1)[inside]
        ei, zi = e[inside], tri[inside, :, 2]
        z = (ei[:, 1] * zi[:, 0] + ei[:, 2] * zi[:, 1]
             + ei[:, 0] * zi[:, 2]) / area
        out.append(min([edge, *np.abs(z - q[2])]))
    return out


class Smoke:
    def __init__(self):
        import torch

        from kaolin_tpu_torch.render.camera import Camera
        from kaolin_tpu_torch.render.mesh import (
            cuda_rasterize,
            cuda_regather,
            cuda_soft_mask,
            cuda_texture,
            dibr,
            rasterization,
        )
        from kaolin_tpu_torch.render.mesh import utils as mesh_utils
        from kaolin_tpu_torch.render.spc import cuda_raster, raster
        from kaolin_tpu_torch.utils import (
            cuda_build,
            cuda_gather,
            from_numpy_tree,
            primitives_bench,
            profiling,
        )

        self.torch = torch
        self.device = "cuda"
        self.cr, self.cs = cuda_rasterize, cuda_soft_mask
        self.ctex, self.mesh_utils = cuda_texture, mesh_utils
        self.creg = cuda_regather
        self.dibr, self.rast = dibr, rasterization
        self.craster, self.sr = cuda_raster, raster
        self.cg, self.pb, self.profiling = (cuda_gather, primitives_bench,
                                            profiling)
        self.Camera = Camera
        self.cuda_build = cuda_build
        self.from_numpy_tree = from_numpy_tree
        self.ex = load_example("torch_dibr_optimization")
        self.spc_ex = load_example("torch_spc_raster")
        self.sim_ex = load_example("torch_simplicits_drop")
        self.col_ex = load_example("torch_collision_stack")
        self.col = {}   # collision_10k's scene and measurements
        self.train_ex = load_example("torch_simplicits_train")
        self.train = {}   # the training path's measurements
        self.tex_ex = load_example("torch_dibr_texture_fit")
        self.texfit = {}  # the texture fit's measurements
        self.rt_ex = load_example("torch_spc_raytrace")
        self.flexi_ex = load_example("torch_flexicubes_sdf")
        self.dmtet_ex = load_example("torch_tutorial_dmtet")
        from kaolin_tpu_torch import metrics
        from kaolin_tpu_torch.ops import conversions, voxelgrid
        self.FlexiCubes = conversions.FlexiCubes
        self.conv, self.vgops, self.metrics = conversions, voxelgrid, metrics
        self.flexi = {}   # config 4: its states and measurements
        self.gauss_ex = load_example("torch_simulatable_gaussians")
        self.gauss = {}   # config 5: its scene and measurements
        self.render_ex = load_example("torch_easy_render")
        self.render = {}  # the full render: its measurements
        # imported by name: the dataset's spawned workers unpickle its
        # preprocessing transform from it
        sys.path.insert(0, os.path.join(ROOT, "examples"))
        self.asset_ex = importlib.import_module("torch_asset_render")
        from kaolin_tpu_torch import io as kio
        self.kio = kio
        self.io = {}      # the asset from disk: its measurements
        from kaolin_tpu_torch import native
        from kaolin_tpu_torch.io import usd
        from kaolin_tpu_torch.io.usd import core as usd_core
        from kaolin_tpu_torch.io.usd import crate as usd_crate
        from kaolin_tpu_torch.native import build as native_build
        self.native, self.native_build = native, native_build
        self.usd_io, self.usd_core, self.usd_crate = usd, usd_core, usd_crate
        self.usd_ex = load_example("torch_usd_asset")
        from kaolin_tpu_torch import visualize
        self.visualize = visualize
        self.usd = {}     # the asset through USD: its measurements
        from kaolin_tpu_torch.render.spc import raytrace
        self.rt = raytrace
        self.spcrt = {}   # config 3 as written: its scene and measurements
        from kaolin_tpu_torch.physics.common import Collision, optimization
        self.opt = optimization
        self.Collision = Collision
        self.newton = optimization.newtons_method
        self.sim = {}   # the sim step's measurements, for the bound
        self.failures = []
        self.results = {name: dict(meta) for name, meta in KERNELS.items()}
        self._config3 = None
        self.per_step = {}   # kernel -> launches per step or frame
        self.driven = {}     # kernel -> launches in the last drive()

    # -- helpers ---------------------------------------------------------
    def counters(self):
        """Each kernel by its name here → its launch counter's name in the
        port's registry (``profiling.counters()``)."""
        return {"winner": self.cr.LAUNCHES,
                "soft_mask_fwd": self.cs.FWD_LAUNCHES,
                "soft_mask_bwd": self.cs.BWD_LAUNCHES,
                "spc_raster": self.craster.RASTER_LAUNCHES,
                "spc_untile": self.craster.UNTILE_LAUNCHES,
                "table_gather_smem": self.cg.SMEM_LAUNCHES,
                "table_gather_l2": self.cg.L2_LAUNCHES,
                "texture_fwd": self.ctex.FWD_LAUNCHES,
                "texture_bwd": self.ctex.BWD_LAUNCHES,
                "regather_fwd": self.creg.FWD_LAUNCHES,
                "regather_bwd": self.creg.BWD_LAUNCHES}

    def gather_fn(self, name):
        """The table gather's route ``name`` (one of GATHER_KERNELS)."""
        return {"table_gather_smem": self.cg.table_gather_smem_cuda,
                "table_gather_l2": self.cg.table_gather_l2_cuda}[name]

    def launches(self):
        """Every kernel's launches so far, and the soft-mask forward's given
        the rasterizer's ids (``soft_mask_fwd_with_face_idx``)."""
        got = self.profiling.counters()
        out = {k: got[name] for k, name in self.counters().items()}
        out["soft_mask_fwd_with_face_idx"] = got[self.cs.FWD_WITH_FACE_IDX]
        return out

    def drive(self, names, path):
        """Run ``path`` → (its result, the launches of the kernels ``names``
        it made: what every counter would read had it been set to 0 just
        before and read just after, as the phases' descriptions say). Every
        counter's launches during it stay in ``self.driven``."""
        before = self.launches()
        out = path()
        self.torch.cuda.synchronize()
        self.driven = {k: n - before[k] for k, n in self.launches().items()}
        return out, {k: self.driven[k] for k in names}

    def check(self, ok, what):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def record_err(self, name, err):
        """Keep the largest error a kernel showed over the parity cases."""
        r = self.results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)

    def random_case(self):
        """64 random faces at 72x100 (ragged), B = 2: 16 faces culled
        (face_normals_z < 0), one with face_normals_z == 0 (kept), and two
        zero-area faces, a point on a pixel centre and a segment along a
        pixel row, which cover pixels only inside their bounding boxes."""
        rng = np.random.RandomState(0)
        tri = (rng.randn(2, 64, 3, 3) * 0.4).astype(np.float32)
        fvi = tri[..., :2] * np.float32(1000.0)
        # pixel centres as _pixel_coords rounds them: fl(1000 / n) * k
        x = np.float32(1000.0 / 100) * np.float32(2 * 60 + 1 - 100)
        y = np.float32(1000.0 / 72) * np.float32(72 - 2 * 30 - 1)
        fvi[:, 17] = [[x, y]] * 3
        fvi[:, 18] = [[-300.0, y], [100.0, y], [400.0, y]]
        nz = rng.randn(2, 64).astype(np.float32)
        nz[:, :16] = -1.0
        nz[:, 16] = 0.0
        nz[:, 17:19] = 1.0
        data = self.from_numpy_tree(
            {"fvz": tri[..., 2] - 2.0, "fvi": fvi, "valid": nz >= 0}, "cuda")
        return data, 72, 100

    def sphere_case(self, res):
        d = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        return ({"fvz": d["face_vertices_z"],
                 "fvi": (d["face_vertices_image"] * 1000.0).contiguous(),
                 "valid": d["face_normals_z"] >= 0}, res, res)

    def sphere_pair_case(self, res):
        """Config 2's sphere and a copy scaled by 0.9 as a batch of two:
        9,984 faces, more than the backward plan takes in one pass."""
        d, h, w = self.sphere_case(res)
        torch = self.torch
        return ({"fvz": torch.cat([d["fvz"], d["fvz"]]),
                 "fvi": torch.cat([d["fvi"], d["fvi"] * 0.9]).contiguous(),
                 "valid": torch.cat([d["valid"], d["valid"]])}, h, w)

    def screen_faces_case(self):
        """100 faces whose enlarged boxes each hold all of a 512x512 image,
        with edges across it, and a seeded cotangent: 6,400 bands of 4,096
        pixels outgrow the backward's 4,296 band slots, so its plan makes
        the bands twice as large."""
        rng = np.random.RandomState(3)
        r = rng.uniform(0, 200, (1, 100, 4)).astype(np.float32)
        t = rng.uniform(-1000, 1000, (1, 100, 2)).astype(np.float32)
        fvi = np.stack([np.stack([-1100 - r[..., 0], -1100 - r[..., 1]], -1),
                        np.stack([1100 + r[..., 2], t[..., 0]], -1),
                        np.stack([t[..., 1], 1100 + r[..., 3]], -1)], 2)
        g = rng.randn(1, 512, 512).astype(np.float32)
        return self.from_numpy_tree({**with_depth(fvi, 4), "g": g},
                                    "cuda"), 512, 512

    def soft_cotangent(self, d, h, w):
        """The cotangent on allprob that loss sum(soft²) gives, and
        allprob, for a case."""
        torch = self.torch
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)
            allprob = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                1000.0, h, w)
            g = torch.where(idx >= 0, 0.0, -2.0 * (1.0 - allprob))
        return g, allprob

    def time_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def compare_times(self, kernel_fn, plain_fn, reps, plain_reps):
        """Medians over plain, kernel, kernel, plain runs."""
        p = self.time_ms(plain_fn, plain_reps)
        k = self.time_ms(kernel_fn, reps)
        k += self.time_ms(kernel_fn, reps)
        p += self.time_ms(plain_fn, plain_reps)
        return statistics.median(k), statistics.median(p)

    # -- phases ----------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.card = card_line()
        print(f"card: {self.card}")
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device "
              f"{torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}", flush=True)

    def phase_build(self):
        cb = self.cuda_build
        print("building:", " ".join(cb.NVCC_FLAGS))
        for s in cb.sources():
            print("  source", os.path.relpath(s, ROOT))
        t0 = time.perf_counter()
        cb.library()
        print(f"built {os.path.relpath(cb.library_path(), ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def adversarial_case(self):
        fvi, g, h, w = adversarial_faces()
        return self.from_numpy_tree({**with_depth(fvi, 11), "g": g},
                                    "cuda"), h, w

    def forward_cases(self):
        """The winner search's and the soft-mask forward's parity cases:
        (label, (faces with z and validity, H, W))."""
        dense, h, w = dense_tile_faces()
        adv = self.adversarial_case()
        return [("random 72x100 B=2", self.random_case()),
                (f"sphere {RES}x{RES}", self.sphere_case(RES)),
                (f"adversarial {adv[1]}x{adv[2]} B=2", adv),
                (f"sphere pair {RES}x{RES} B=2", self.sphere_pair_case(RES)),
                ("100 faces over 512x512", self.screen_faces_case()),
                ("2,000 faces in one 16x16 tile",
                 (self.from_numpy_tree(dense, "cuda"), h, w))]

    def phase_parity(self):
        torch = self.torch
        for label, (d, h, w) in self.forward_cases():
            ids_k = self.cr.rasterize_search_cuda(d["fvz"], d["fvi"],
                                                  d["valid"], 1000, 1e-8, h, w)
            ids_p = self.rast.rasterize_search_plain(d["fvz"], d["fvi"],
                                                     d["valid"], 1000, 1e-8,
                                                     h, w)
            bad = int((ids_k != ids_p).sum())
            hits = int((ids_p >= 0).sum())
            self.check(bad == 0 and hits > 0,
                       f"winner ids exact [{label}]: {bad} of {ids_p.numel()}"
                       f" differ ({hits} covered)")
            self.record_err("winner", float((ids_k - ids_p).abs().max()))
            if label.startswith("random"):
                rows = torch.nonzero(ids_k == 18)[:, 1]
                self.check(bool((ids_k[:, 30, 60] == 17).all())
                           and rows.numel() > 0 and bool((rows == 30).all()),
                           f"zero-area faces stay in their boxes [{label}]")

            ap_k = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                              h, w)
            with torch.no_grad():
                ap_p = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                 1000.0, h, w)
            err = float((ap_k - ap_p).abs().max())
            self.check(err <= 1e-5 and float(ap_p.min()) < 0.99,
                       f"soft-mask forward within 1e-5 [{label}]: "
                       f"max abs err {err:.3e}")
            self.record_err("soft_mask_fwd", err)
            again = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                               h, w)
            same = torch.equal(again.view(torch.int32), ap_k.view(torch.int32))
            ap_i = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                              h, w, face_idx=ids_k)
            free = ids_k < 0
            kept = torch.equal(ap_i[free].view(torch.int32),
                               ap_k[free].view(torch.int32))
            ones = bool((ap_i[~free] == 1.0).all())
            self.check(same and kept and ones,
                       f"soft-mask forward bitwise across two launches "
                       f"{same}; with face_idx bitwise equal at "
                       f"{int(free.sum())} uncovered pixels {kept}, 1.0 at "
                       f"{int((~free).sum())} covered {ones} [{label}]")
        edge = self.edge_case()
        bwd_cases = [("random 72x100 B=2", self.random_case()),
                     ("sphere 128x128", self.sphere_case(128)),
                     (f"sphere {RES}x{RES}", self.sphere_case(RES)),
                     ("adversarial 72x100 B=2", self.adversarial_case()),
                     ("sphere pair 128x128 B=2", self.sphere_pair_case(128)),
                     ("100 faces over 512x512", self.screen_faces_case()),
                     ("a pixel centre 0.001 from an edge 16x16", edge)]
        for label, (d, h, w) in bwd_cases:
            soft = d.get("soft", (7000.0, 0.02))
            args = (*soft, 1000.0, h, w)
            if "g" in d:
                g = d["g"]
                with torch.no_grad():
                    allprob = self.dibr.soft_mask_plain(d["fvi"], *args)
            else:
                g, allprob = self.soft_cotangent(d, h, w)
            ga = (g * allprob).contiguous()
            grad_k = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
            grad_p = self.dibr._soft_mask_bwd_plain(d["fvi"], ga, *args)
            scale = float(grad_p.abs().max())
            err = float((grad_k - grad_p).abs().max())
            self.check(scale > 0 and err / scale <= 1e-4,
                       f"soft-mask backward within 1e-4 of max|grad| "
                       f"[{label}]: max abs err {err:.3e}, max|grad| "
                       f"{scale:.3e}, ratio {err / max(scale, 1e-30):.3e}")
            self.record_err("soft_mask_bwd", err)
            if label.startswith("sphere 512"):
                again = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
                same = torch.equal(again.view(torch.int32),
                                   grad_k.view(torch.int32))
                self.check(same, f"soft-mask backward bitwise equal across "
                           f"two launches [{label}]: {same}")
        d, h, w = edge
        r, c = d["pixel"]
        only = torch.zeros_like(d["g"])
        only[0, r, c] = 1.0
        args = (EDGE_SIGMAINV, EDGE_BOXLEN, 1000.0, h, w)
        with torch.no_grad():
            allprob = self.dibr.soft_mask_plain(d["fvi"], *args)
        ga = (only * allprob).contiguous()
        zero_k = self.cs.soft_mask_bwd_cuda(d["fvi"], ga, *args)
        zero_p = self.dibr._soft_mask_bwd_plain(d["fvi"], ga, *args)
        self.check(float(allprob[0, r, c]) == 0.0
                   and not bool(zero_k.any()) and not bool(zero_p.any()),
                   "F11: a cotangent only where 1 - p rounds to 0 gives every"
                   " face exactly 0, kernel and plain: max "
                   f"{float(zero_k.abs().max()):.3e} and "
                   f"{float(zero_p.abs().max()):.3e}")
        self.check_jax_style_calls()
        torch.cuda.synchronize()

    def edge_case(self):
        fvi, g, h, w, pixel = edge_pixel_faces()
        d = self.from_numpy_tree({"fvi": fvi, "g": g}, "cuda")
        d["soft"], d["pixel"] = (EDGE_SIGMAINV, EDGE_BOXLEN), pixel
        return d, h, w

    def check_jax_style_calls(self):
        """F12: ``dibr_rasterization`` and ``dibr_soft_mask`` called with
        the JAX package's arguments in its positions, on the card: bit for
        bit the results of the calls without them."""
        torch = self.torch
        d = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        args = (RES, RES, d["face_vertices_z"], d["face_vertices_image"],
                d["face_features"], d["face_normals_z"])
        with torch.no_grad():
            want = self.dibr.dibr_rasterization(*args)
            got = self.dibr.dibr_rasterization(*args, 7000, 0.02, 30, None,
                                               None, "binned", 16, 512)
            mask = self.dibr.dibr_soft_mask(d["face_vertices_image"], want[2],
                                            7000, 0.02, 30, 1000.0, 16, 512,
                                            "pallas", "all")
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        self.check(same and torch.equal(mask, want[1]),
                   f"F12: JAX-style positional calls on the card equal the "
                   f"plain calls at config 2: {same}")

    def plain_loss(self, inputs, fvi, feats, res):
        """config2_loss with the plain versions in place of the kernels."""
        torch = self.torch
        scaled = fvi * 1000
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                inputs["face_vertices_z"], scaled.detach(),
                inputs["face_normals_z"] >= 0, 1000, 1e-8, res, res)
        img = self.rast.interpolate_at_winners_plain(idx, scaled, feats, 1000,
                                                     1e-8)
        allprob = self.dibr.soft_mask_plain(scaled, 7000, 0.02, 1000.0, res,
                                            res)
        soft = torch.where(idx >= 0, 1.0, 1.0 - allprob)
        return torch.sum(img ** 2) + torch.sum(soft ** 2)

    def phase_main_path(self):
        torch = self.torch
        out, launches = self.drive(
            DIBR_KERNELS,
            lambda: self.ex.config2_step("cuda", res=RES, steps=STEPS))
        print(f"config2_step {RES}x{RES}, {STEPS} steps: losses "
              f"{out['losses']}; launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"main path launched {k} ({n} times)")
        with_idx = self.driven["soft_mask_fwd_with_face_idx"]
        self.check(with_idx == launches["soft_mask_fwd"],
                   f"main path gave the soft-mask forward the rasterizer's "
                   f"ids at {with_idx} of {launches['soft_mask_fwd']} launches")
        self.check(all(map(lambda x: x == x and abs(x) != float("inf"),
                           out["losses"])), "config-2 losses finite")
        for name in ("grad_fvi", "grad_feat"):
            g = out[name]
            self.check(bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0,
                       f"config-2 {name} finite and non-zero "
                       f"(max {float(g.abs().max()):.3e})")

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        lk, gvk, gfk = self.ex.config2_grad(inputs, fvi, feats, RES)
        lp, gvp, gfp = self.ex.config2_grad(inputs, fvi, feats, RES,
                                            loss_fn=self.plain_loss)
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        self.check(rel <= 1e-5, f"config-2 loss kernels vs plain: "
                   f"{float(lk):.6f} vs {float(lp):.6f} (rel {rel:.2e})")
        for name, a, b in (("fvi", gvk, gvp), ("features", gfk, gfp)):
            ratio = float((a - b).abs().max() / b.abs().max())
            self.check(ratio <= 1e-4, f"config-2 grad {name} kernels vs "
                       f"plain within 1e-4 of max: {ratio:.2e}")

        (losses, shift), counts1 = self.drive(
            DIBR_KERNELS, lambda: self.ex.main("cuda", res=64, iters=60))
        self.check(losses[-1] < 0.30 and abs(shift) < 0.05,
                   f"64x64 optimisation: final loss {losses[-1]:.4f} "
                   f"(< 0.30), shift {shift:+.4f} (|.| < 0.05); "
                   f"launches {counts1}")
        self.check(all(n > 0 for n in counts1.values()),
                   "64x64 optimisation ran through every kernel")

    def phase_timing(self):
        torch = self.torch
        print(f"timing on {self.card}", flush=True)
        d, h, w = self.sphere_case(RES)
        g, allprob = self.soft_cotangent(d, h, w)
        ga = (g * allprob).contiguous()
        ids = self.cr.rasterize_search_cuda(d["fvz"], d["fvi"], d["valid"],
                                            1000, 1e-8, h, w)
        pairs = {
            "winner": (
                lambda: self.cr.rasterize_search_cuda(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w),
                lambda: self.rast.rasterize_search_plain(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)),
            "soft_mask_fwd": (   # as the main path calls it, with the ids
                lambda: self.cs.soft_mask_fwd_cuda(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w, face_idx=ids),
                lambda: self.dibr.soft_mask_plain(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w, face_idx=ids)),
            "soft_mask_bwd": (
                lambda: self.cs.soft_mask_bwd_cuda(
                    d["fvi"], ga, 7000.0, 0.02, 1000.0, h, w),
                lambda: self.dibr._soft_mask_bwd_plain(
                    d["fvi"], ga, 7000.0, 0.02, 1000.0, h, w)),
        }
        for name, (kern, plain) in pairs.items():
            with torch.no_grad():
                k_ms, p_ms = self.compare_times(kern, plain, 20, 5)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name} at {h}x{w}, 4992 faces, B=1: kernel {k_ms:.4f} ms,"
                  f" plain {p_ms:.4f} ms", flush=True)
        every = statistics.median(self.time_ms(
            lambda: self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                               h, w), 20))
        print(f"soft_mask_fwd without face_idx (every pixel): kernel "
              f"{every:.4f} ms", flush=True)

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        k_ms, p_ms = self.compare_times(
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES),
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES,
                                         loss_fn=self.plain_loss), 10, 3)
        print(f"config-2 step (forward + backward) at {RES}x{RES}, 4992 "
              f"faces: kernels {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"[{self.card}]", flush=True)

    # -- the DIB-R pose-and-texture fit (config 2 as written) -------------
    def texfit_state(self, scene):
        """A seeded state of the fit away from its start (offsets, texture,
        pose and scale all moved), as the fit's parameters on the scene's
        device: the same numbers on every device."""
        torch = self.torch
        rng = np.random.RandomState(7)
        v = scene["template"].shape[0]
        tex = scene["target_texture"].shape[-1]
        state = {"texture": rng.uniform(0.3, 0.7, (3, tex, tex)),
                 "offsets": rng.normal(0.0, 0.02, (v, 3)),
                 "q": [0.05, -0.03, 0.02, 1.0], "t": [0.02, 0.0, -0.01],
                 "s": [0.05]}
        dev = scene["template"].device
        return {k: torch.tensor(np.asarray(x, np.float32), device=dev,
                                requires_grad=True)
                for k, x in state.items()}

    def texfit_grad(self, scene, step=1):
        """One forward and backward of the fit's loss at ``texfit_state``
        → (loss, its terms, soft mask, face_idx, {param: gradient})."""
        params = self.texfit_state(scene)
        loss, terms, soft, idx = self.tex_ex.texfit_loss(scene, params, step)
        loss.backward()
        return (loss.detach(), terms, soft.detach(), idx,
                {k: params[k].grad for k in self.tex_ex.PARAMS})

    def phase_texfit_parity(self):
        """One step of the texture fit at 512², B = 2, on the card against
        the same step on the port's CPU path (the plain versions) from the
        same inputs: the target views rendered on the card and copied, and
        one seeded state. face_idx equal, the soft mask within 1e-5, the
        loss within 1e-5 relative, each parameter's gradient within 1e-4 of
        its largest entry (the texture's gradient is a scatter whose adds
        collide on the card). Then ``texture_mapping`` alone, card against
        CPU, at the template's UVs (the seam at u = 1, the first and last
        rings at v = 0 and 1)."""
        torch, ex = self.torch, self.tex_ex
        card = ex.texfit_setup(ex.texfit_inputs(), "cuda", RES)
        cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in card.items()}
        t0 = time.perf_counter()
        got = self.texfit_grad(card)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = self.texfit_grad(cpu)
        t2 = time.perf_counter()
        self.check(torch.equal(got[3].cpu(), want[3]),
                   f"texture fit at {RES}x{RES}, B=2: face_idx card = CPU "
                   f"({int((want[3] >= 0).sum())} covered pixels; card "
                   f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s host)")
        err = float((got[2].cpu() - want[2]).abs().max())
        self.check(err <= 1e-5, f"texture fit soft mask card vs CPU: max "
                   f"|diff| {err:.2e} (1e-5)")
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        self.check(rel <= 1e-5, f"texture fit loss card vs CPU: "
                   f"{float(got[0]):.7f} vs {float(want[0]):.7f} (rel "
                   f"{rel:.2e}; terms "
                   + ", ".join(f"{k} {float(v.detach()):.6f}"
                               for k, v in want[1].items()) + ")")
        for k in ex.PARAMS:
            g, w = got[4][k].cpu(), want[4][k]
            ratio = float((g - w).abs().max() / w.abs().max())
            self.check(ratio <= TEXFIT_GRAD_TOL and float(w.abs().max()) > 0,
                       f"texture fit grad {k} {tuple(w.shape)} card vs CPU "
                       f"within {TEXFIT_GRAD_TOL:g} of max "
                       f"{float(w.abs().max()):.3e}: {ratio:.2e}")
        # texture_mapping alone at the template's corner UVs and between
        from kaolin_tpu_torch.render.mesh import texture_mapping
        uv = card["face_uvs"].reshape(1, -1, 2)
        rng = np.random.RandomState(8)
        uv = torch.cat([uv, torch.tensor(rng.uniform(0, 1, (1, 500, 2)),
                                         dtype=torch.float32,
                                         device="cuda")], 1)
        tex = card["target_texture"][None]
        w = torch.tensor(rng.randn(1, uv.shape[1], 3), dtype=torch.float32,
                         device="cuda")
        for mode in ("bilinear", "nearest"):
            out = {}
            for dev in ("cuda", "cpu"):
                u = uv.to(dev).clone().requires_grad_(True)
                t = tex.to(dev).clone().requires_grad_(True)
                val = texture_mapping(u, t, mode)
                (val * w.to(dev)).sum().backward()
                out[dev] = [x.detach().cpu() for x in
                            (val, t.grad, u.grad if u.grad is not None
                             else torch.zeros_like(u))]
            errs = [float((a - b).abs().max()) for a, b in
                    zip(out["cuda"], out["cpu"])]
            scale = float(out["cpu"][1].abs().max())
            self.check(errs[0] <= 1e-6 and errs[1] <= 1e-5 * scale
                       and errs[2] <= 1e-5 * max(
                           float(out["cpu"][2].abs().max()), 1.0),
                       f"texture_mapping {mode} card vs CPU at "
                       f"{uv.shape[1]} UVs (the template's corners: the "
                       f"seam at u = 1, rings at v = 0 and 1): values "
                       f"{errs[0]:.2e}, texture grad {errs[1]:.2e} (max "
                       f"{scale:.3e}), UV grad {errs[2]:.2e}")
        self.texture_parity()

    def texture_case(self, views, tex_side, seed, shared=True,
                     per_view=False):
        """Inputs of the texture kernels as the fit hands them over: UVs
        (views, 512, 512, 2) as a slice of a (views, 512, 512, 3) feature
        image, 0 outside a disc of ~29% of each view (the background), in
        [-0.1, 1.1] inside with rows at exactly 0 and 1 in u and in v; the
        output cotangent, 0 at the background and at 5% of the disc's
        pixels, one channel 0 at 5% more, random elsewhere; a 3 x side²
        texture leaf, expanded to every view (``shared``), one a view
        (``per_view``) or given as a batch of one → dict."""
        torch = self.torch
        rng = np.random.RandomState(seed)
        res = RES
        yy, xx = np.mgrid[:res, :res].astype(np.float32)
        feats = np.zeros((views, res, res, 3), np.float32)
        cot = np.zeros((views, res, res, 3), np.float32)
        for v in range(views):
            cy, cx = rng.uniform(0.35, 0.65, 2) * res
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < 0.29 * res * res / np.pi
            n = int(disc.sum())
            feats[v][disc, :2] = rng.uniform(-0.1, 1.1, (n, 2))
            feats[v][disc, 2] = 1.0
            cot[v][disc] = rng.randn(n, 3)
            kill = rng.rand(n)
            cot[v][disc] *= (kill >= 0.05)[:, None]
            cot[v][disc, 1] *= (kill < 0.05) | (kill >= 0.10)
        rows = np.nonzero(feats[..., 2].any(axis=(0, 2)))[0]
        for k, (ch, val) in enumerate(((0, 0.0), (0, 1.0), (1, 0.0),
                                       (1, 1.0))):
            row = rows[len(rows) * (k + 1) // 5]
            feats[:, row, :, ch] = np.where(feats[:, row, :, 2] > 0, val,
                                            0.0)
        tex = rng.uniform(0, 1, ((views if per_view else 1) * 3, tex_side,
                                 tex_side)).astype(np.float32)
        tex = tex.reshape(-1, 3, tex_side, tex_side) if per_view \
            else tex.reshape(3, tex_side, tex_side)
        return {"feats": torch.from_numpy(feats).cuda(),
                "cot": torch.from_numpy(cot).cuda(),
                "tex": torch.from_numpy(tex).cuda(), "shared": shared,
                "per_view": per_view}

    def texture_call(self, case, fn, mode, dtype=None, cot=None):
        """``fn`` (texture_mapping, or its plain version on the card) on a
        fresh copy of ``case``'s leaves, the texture in ``dtype`` where
        given (the UVs stay float32), backward with ``cot`` (else the
        case's cotangent) in the texture's dtype → (samples, UV gradient
        or zeros, texture gradient)."""
        torch = self.torch
        dtype = dtype or torch.float32
        feats = case["feats"].clone().requires_grad_(True)
        uv = torch.split(feats, [2, 1], dim=-1)[0]
        tex = case["tex"].to(dtype, copy=True).requires_grad_(True)
        views = feats.shape[0]
        if case["per_view"]:
            batch = tex
        elif case["shared"]:
            batch = tex[None].expand(views, -1, -1, -1)
        else:
            batch = tex[None]
        if fn is self.mesh_utils.texture_mapping_plain:
            val = fn(uv.reshape(views, -1, 2), batch, mode).reshape(
                *uv.shape[:-1], -1)
        else:
            val = fn(uv, batch, mode)
        val.backward((case["cot"] if cot is None else cot).to(dtype))
        grad_uv = (torch.zeros_like(uv) if feats.grad is None   # nearest
                   else feats.grad[..., :2].clone())
        return val.detach(), grad_uv, tex.grad

    def texture_tap_counts(self, case, mode):
        """The adds onto each entry of the texture's gradient from the
        pixels with a non-zero cotangent (4 taps, or 1 in "nearest", in
        every channel), the taps computed op for op as ``_grid_sample_2d``
        and the kernels compute them → float64 of the texture leaf's shape
        with 1 channel."""
        torch = self.torch
        feats, tex = case["feats"], case["tex"]
        views = feats.shape[0]
        h, w = tex.shape[-2:]
        uv = feats[..., :2].reshape(views, -1, 2)
        live = (case["cot"] != 0).any(-1).reshape(views, -1)
        c = uv.clamp(0.0, 1.0) * 2.0 - 1.0
        x = (c[..., 0] + 1.0) * (w / 2.0) - 0.5
        y = (c[..., 1] * -1.0 + 1.0) * (h / 2.0) - 0.5
        if mode == "nearest":
            taps = [(torch.round(y).to(torch.int32).clamp(0, h - 1),
                     torch.round(x).to(torch.int32).clamp(0, w - 1))]
        else:
            x0 = torch.floor(x).to(torch.int32)
            y0 = torch.floor(y).to(torch.int32)
            taps = [(yi.clamp(0, h - 1), xi.clamp(0, w - 1))
                    for yi in (y0, y0 + 1) for xi in (x0, x0 + 1)]
        slot = (torch.arange(views, device=uv.device)[:, None] * (h * w)
                if case["per_view"] else 0)
        idx = torch.cat([(slot + yi.long() * w + xi.long())[live]
                         for yi, xi in taps])
        n_tex = views if case["per_view"] else 1
        counts = torch.bincount(idx, minlength=n_tex * h * w)
        return counts.double().reshape(*tex.shape[:-3], 1, h, w)

    def texture_parity(self):
        """Kernel #7 against its plain version on the card at both cells'
        shapes: 8 x 512² UVs with one shared 3 x 256² and 3 x 1,024²
        texture (batch stride 0), a texture a view (8 x 3 x 256²), and a
        batch of one with a 1,024² texture as easy_render passes it, in
        both modes; UVs at exactly 0 and 1 and outside [0, 1], pixels with
        a zero and a non-zero cotangent. Values within TEXTURE_VALUE_TOL
        and the UVs' gradient within TEXTURE_UV_GRAD_TOL of the plain
        version's; every entry of the texture's gradient, the kernel's and
        the plain version's, within its float32 rounding bound of the
        float64 sum of the same products (TEXTURE_SUM_ULP), which for the
        shared texture is the sum over the views that the plain version's
        ``expand`` takes (so added once, not 8 times; the norms' ratio
        printed); one launch each way; and in a profiled backward the two pixel counters
        against a count of the pixels and of those with a non-zero
        cotangent."""
        torch, tm = self.torch, self.mesh_utils
        plain = tm.texture_mapping_plain
        cases = [(f"{cell} shapes, shared {side}² texture", TEXTURE_VIEWS,
                  side, {}) for cell, side in TEXTURE_SIDES.items()]
        cases += [("a 256² texture a view", TEXTURE_VIEWS, 256,
                   {"per_view": True}),
                  ("a batch of one, 1,024² texture", 1, 1024,
                   {"shared": False})]
        worst = {"texture_fwd": 0.0, "texture_bwd": 0.0}
        for i, (label, views, side, kw) in enumerate(cases):
            case = self.texture_case(views, side, 20 + i, **kw)
            live = int((case["cot"] != 0).any(-1).sum())
            for mode in ("bilinear", "nearest"):
                got, n = self.drive(TEXTURE_KERNELS, lambda: self.texture_call(
                    case, tm.texture_mapping, mode))
                want = self.texture_call(case, plain, mode)
                f64 = torch.float64
                exact = self.texture_call(case, plain, mode, f64)
                mag = self.texture_call(case, plain, mode, f64,
                                        case["cot"].abs())[2]
                adds = self.texture_tap_counts(case, mode)
                bound = (adds + views + 2) * TEXTURE_SUM_ULP * mag
                off = {k: (g[2].double() - exact[2]).abs()
                       for k, g in (("kernel", got), ("plain", want))}
                within = {k: bool((o <= bound).all()) for k, o in off.items()}
                share = {k: float((o / bound.clamp_min(1e-300)).max())
                         for k, o in off.items()}
                val_err = float((got[0] - want[0]).abs().max())
                equal = bool(torch.equal(got[0], want[0]))
                scale = [float(w.abs().max()) for w in want[1:]]
                errs = [float((g - w).abs().max()) for g, w in
                        zip(got[1:], want[1:])]
                ratio = float(got[2].norm() / want[2].norm())
                worst["texture_fwd"] = max(worst["texture_fwd"], val_err)
                worst["texture_bwd"] = max(worst["texture_bwd"], errs[1])
                self.check(val_err <= TEXTURE_VALUE_TOL
                           and errs[0] <= TEXTURE_UV_GRAD_TOL
                           * max(scale[0], 1.0) and all(within.values())
                           and (mode == "bilinear") == (scale[0] > 0)
                           and n == {"texture_fwd": 1, "texture_bwd": 1},
                           f"texture kernel {mode} [{label}], {live} live of "
                           f"{views * RES * RES} pixels: values max |diff| "
                           f"{val_err:.2e} (bitwise equal {equal}), UV grad "
                           f"{errs[0]:.2e} (max {scale[0]:.3e}), texture "
                           f"grad {errs[1]:.2e} from the plain version's "
                           f"(max {scale[1]:.3e}); from the float64 sum of "
                           f"the same products: kernel "
                           f"{float(off['kernel'].max()):.2e}, plain "
                           f"{float(off['plain'].max()):.2e}, at most "
                           f"{share['kernel']:.4f} and {share['plain']:.4f} "
                           f"of an entry's bound (up to "
                           f"{int(adds.max())} adds on an entry); norm "
                           f"ratio {ratio:.7f}; launches {n}")
            counted = self.texture_pixel_counters(case)
            self.check(counted == (views * RES * RES, live),
                       f"texture backward's pixel counters [{label}]: "
                       f"{counted} against {views * RES * RES} pixels, "
                       f"{live} with a non-zero cotangent")
        for k, err in worst.items():
            self.record_err(k, err)

    def texture_pixel_counters(self, case):
        """The backward's two device counters over one profiled bilinear
        call → (pixels, pixels_added)."""
        torch = self.torch
        self.texture_call(case, self.mesh_utils.texture_mapping, "bilinear")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            self.texture_call(case, self.mesh_utils.texture_mapping,
                              "bilinear")
            torch.cuda.synchronize()
        got = self.profiling.counters()
        return tuple(got.get(k) for k in self.ctex.PIXELS)

    def regather_fit_case(self, cell, seed, steps=REGATHER_STEPS):
        """The re-gather's inputs and its output's gradient as the DIB-R fit
        hands them over in ``cell`` (the benchmark's configuration and
        traffic, from ``seed``) after ``steps`` steps → dict (face_idx,
        scaled, features, cot, multiplier, eps)."""
        from portbench import harness
        from portbench.fits import dibr as fit

        _, _, cfg, mix = harness.cell(harness.benchmark(), cell)
        state = fit.build(cfg, fit.make_inputs(cfg, mix, seed, "cuda"),
                          "cuda")
        for _ in range(steps):
            fit.step(state)
        kept = {}
        real = self.rast._interpolate_at_winners

        def keep(face_idx, scaled, features, multiplier, eps):
            out = real(face_idx, scaled, features, multiplier, eps)
            out.retain_grad()
            kept.update(face_idx=face_idx, scaled=scaled.detach(),
                        features=features.detach(), out=out,
                        multiplier=multiplier, eps=eps)
            return out

        self.rast._interpolate_at_winners = keep
        try:
            image, soft, _, _ = fit.render(state["scene"], state["params"])
            fit.losses(state["scene"], state["params"], image, soft)[0] \
                .backward()
        finally:
            self.rast._interpolate_at_winners = real
        kept["cot"] = kept.pop("out").grad.detach()
        return kept

    def regather_call(self, case, fn, cot, feature_grad):
        """``fn`` (``_interpolate_at_winners`` or its plain version) on
        fresh leaves of ``case``, backward with ``cot`` → (output, the
        gradient of scaled, of the features or None)."""
        scaled = case["scaled"].clone().requires_grad_(True)
        feats = case["features"].clone().requires_grad_(feature_grad)
        out = fn(case["face_idx"], scaled, feats, case["multiplier"],
                 case["eps"])
        out.backward(cot)
        return out.detach(), scaled.grad, feats.grad

    def regather_bound(self, case, cot, feature_grad):
        """The float64 sums of each gradient's terms and their bounds
        (REGATHER_CHAIN): [(reference, bound)] for the coordinates' and,
        where asked, the features' gradient."""
        torch = self.torch
        idx, d = case["face_idx"], case["features"].shape[-1]
        args = (idx, case["scaled"], case["features"], cot,
                case["multiplier"], case["eps"], True, feature_grad)
        exact = regather_bwd_rule(*args, dtype=torch.float64)
        mag = regather_bwd_rule(*args, dtype=torch.float64, absolute=True)
        b, f = case["scaled"].shape[:2]
        live = (idx >= 0) & (cot != 0).any(-1)
        rows = (torch.arange(b, device=idx.device)[:, None, None] * f
                + idx.long())[live]
        adds = torch.bincount(rows, minlength=b * f).double().reshape(
            b, f, 1, 1)
        out = [(exact[0], (adds + REGATHER_CHAIN + d) * TEXTURE_SUM_ULP
                * mag[0])]
        if feature_grad:
            out.append((exact[1], (adds + 2) * TEXTURE_SUM_ULP * mag[1]))
        return out

    def phase_regather_parity(self):
        """Kernel #8 against its plain version on the card, at both DIB-R
        cells' shapes on the fit's own data (``regather_fit_case``): the
        forward bit for bit; the backward with the fit's own cotangent
        (the features need no gradient there) and with a seeded one, 0 at
        5% of the hits, asked for the features' gradient too; each
        gradient entry, the kernel's and the plain version's, within its
        bound of the float64 sum of its terms (REGATHER_CHAIN); one forward
        and two backward launches a call (the profiler's names); the pixel
        counters of a profiled backward against the pixels and the live
        ones; then the device ms of the plain version and of the kernel,
        each way, their event ms (plain, kernel, kernel, plain) and the
        bytes bound. The kernel table's row is texfit.v8's."""
        torch = self.torch
        plain = self.rast.interpolate_at_winners_plain
        worst = {"regather_fwd": 0.0, "regather_bwd": 0.0}
        for cell in TEXTURE_SIDES:
            case = self.regather_fit_case(cell, REGATHER_SEED)
            idx, d = case["face_idx"], case["features"].shape[-1]
            b, f = case["scaled"].shape[:2]
            hits = idx >= 0
            rng = torch.Generator(device="cuda").manual_seed(REGATHER_SEED)
            seeded = torch.randn(case["cot"].shape, device="cuda",
                                 generator=rng)
            keep = torch.rand(idx.shape, device="cuda", generator=rng) >= 0.05
            seeded = seeded * (keep | ~hits)[..., None]
            for label, cot, feature_grad in (("the fit's cotangent",
                                              case["cot"], False),
                                             ("a seeded cotangent", seeded,
                                              True)):
                got, n = self.drive(
                    REGATHER_KERNELS, lambda: self.regather_call(
                        case, self.rast._interpolate_at_winners, cot,
                        feature_grad))
                want = self.regather_call(case, plain, cot, feature_grad)
                equal = bool(torch.equal(got[0], want[0]))
                val_err = float((got[0] - want[0]).abs().max())
                within, share = [], []
                for k, (exact, bound) in enumerate(self.regather_bound(
                        case, cot, feature_grad)):
                    for side in (got, want):
                        off = (side[1 + k].double() - exact).abs()
                        within.append(bool((off <= bound).all()))
                        share.append(float((off / bound.clamp_min(1e-300))
                                           .max()))
                errs = [float((g - w).abs().max()) for g, w in
                        zip(got[1:], want[1:]) if w is not None]
                scale = [float(w.abs().max()) for w in want[1:]
                         if w is not None]
                live = int((hits & (cot != 0).any(-1)).sum())
                worst["regather_fwd"] = max(worst["regather_fwd"], val_err)
                worst["regather_bwd"] = max(worst["regather_bwd"], errs[0])
                self.check(equal and all(within)
                           and (got[2] is None) == (not feature_grad)
                           and n == {"regather_fwd": 1, "regather_bwd": 1},
                           f"re-gather kernel [{cell}, {b} x {RES}² pixels, "
                           f"{f} faces, D = {d}, {label}]: values bitwise "
                           f"equal {equal} (max |diff| {val_err:.2e}); "
                           f"{int(hits.sum())} hits, {live} live; gradients' "
                           f"max |diff| from the plain version's {errs} (max "
                           f"{scale}); kernel and plain within the bound of "
                           f"the float64 sums {within}, at most "
                           + ", ".join(f"{x:.4f}" for x in share)
                           + f" of an entry's bound; launches {n}")
            counted, names = self.regather_launches(case)
            live = int((hits & (case["cot"] != 0).any(-1)).sum())
            self.check(counted == (b * RES * RES, live)
                       and names == {"fwd": ["regather_fwd_kernel"],
                                     "bwd": ["regather_bwd_kernel",
                                             "regather_zero_kernel"]},
                       f"re-gather backward's pixel counters [{cell}]: "
                       f"{counted} against {b * RES * RES} pixels, {live} "
                       f"live ({100 * live / (b * RES * RES):.1f}%); device "
                       f"launches a call {names}")
            self.regather_timing(cell, case)
            del case
            torch.cuda.empty_cache()
        for k, err in worst.items():
            self.record_err(k, err)

    def regather_launches(self, case):
        """A profiled call each way → ((pixels, pixels_added) of the
        backward's device counters, {"fwd", "bwd": the sorted names of the
        device launches of one call, each kernel of #8 by its short
        name})."""
        args = (case["face_idx"], case["scaled"], case["features"])
        rest = (case["multiplier"], case["eps"])
        calls = {"fwd": lambda: self.creg.regather_fwd_cuda(*args, *rest),
                 "bwd": lambda: self.creg.regather_bwd_cuda(
                     *args, case["cot"], *rest, True, False)}
        short = ("regather_fwd_kernel", "regather_bwd_kernel",
                 "regather_zero_kernel")
        names = {way: sorted(next((k for k in short if k in n), n)
                             for n, _ in self.device_events(
                                 f"re-gather {way}", fn, 1))
                 for way, fn in calls.items()}
        got = self.profiling.counters()
        return tuple(got.get(k) for k in self.creg.PIXELS), names

    def regather_timing(self, cell, case):
        """Kernel #8 on a cell's own data, the backward as the fit asks for
        it (no features' gradient): each way's device ms (the zero-fill
        counted in the backward's), the CUDA-event ms of one call against
        its plain version's (plain, kernel, kernel, plain), the plain
        version's device ms, and the bytes bound: each byte once, the ids,
        the hit faces' coordinates and features, the output (forward) or
        its gradient and the coordinates' gradient (backward)."""
        torch = self.torch
        plain = self.rast.interpolate_at_winners_plain
        idx, feats = case["face_idx"], case["features"]
        rest = (case["multiplier"], case["eps"])
        scaled = case["scaled"].clone().requires_grad_(True)
        out = plain(idx, scaled, feats, *rest)
        fns = {
            "fwd": (lambda: self.creg.regather_fwd_cuda(
                idx, case["scaled"], feats, *rest),
                lambda: plain(idx, scaled, feats, *rest)),
            "bwd": (lambda: self.creg.regather_bwd_cuda(
                idx, case["scaled"], feats, case["cot"], *rest, True, False),
                lambda: torch.autograd.grad(out, (scaled,), case["cot"],
                                            retain_graph=True))}
        b, f = case["scaled"].shape[:2]
        d = feats.shape[-1]
        pixels = idx.numel()
        winners = int(torch.unique(
            (torch.arange(b, device=idx.device)[:, None, None] * f
             + idx.long())[idx >= 0]).numel())
        nbytes = {"fwd": pixels * 4 + winners * (24 + 12 * d)
                  + pixels * d * 4,
                  "bwd": pixels * 4 + pixels * d * 4
                  + winners * (24 + 12 * d) + b * f * 24}
        for way, (kernel, plain_fn) in fns.items():
            dev = self.device_ms(f"re-gather kernel {way} {cell}", kernel,
                                 names=DEVICE_NAMES[f"regather_{way}"])
            plain_dev = self.device_ms(f"re-gather plain {way} {cell}",
                                       plain_fn)
            k_ms, p_ms = self.compare_times(kernel, plain_fn, 20, 5)
            bound = nbytes[way] / HBM_BYTES_S * 1e3
            print(f"re-gather kernel {way} [{cell}: {b} x {RES}² pixels, "
                  f"{f} faces, {winners} hit, D = {d}]: device "
                  f"{fmt_ms(dev)} ms, event {k_ms:.4f} ms; plain device "
                  f"{fmt_ms(plain_dev)} ms, event {p_ms:.4f} ms; bound "
                  f"{bound:.6f} ms ({nbytes[way]} bytes), share "
                  f"{fmt_ms(dev and bound / dev)} [{self.card}]", flush=True)
            if cell == "texfit.v8":
                k = f"regather_{way}"
                self.results[k].update(device_ms=dev, ms=k_ms, plain_ms=p_ms,
                                       library_ms=None)
                self.set_bound(k, nbytes[way], 0,
                               f"{cell}'s own data, each byte once")

    def phase_texfit_path(self):
        """The texture fit from the example's start, 100 steps at 512²,
        B = 2, each step driven with every launch counter set to 0 just
        before and read just after: #1, #2 and #3 launch on every step
        (the forward given the rasterizer's ids each time), every loss is
        finite, the silhouette term falls by at least half, the pose error
        (the angle to the target quaternion and |t − t*|) falls; the peak
        memory."""
        torch, ex = self.torch, self.tex_ex
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        scene = ex.texfit_setup(ex.texfit_inputs(), "cuda", RES)
        params = ex.initial_params(scene)
        opt = ex.make_optimizer(params)
        start = [float(x) for x in ex.pose_error(scene, params)]
        losses, sil, counts, with_idx, tex_counts = [], [], [], [], []
        for i in range(TEXFIT_PATH_STEPS):
            (loss, terms), n = self.drive(
                DIBR_KERNELS, lambda i=i: ex.texfit_step(scene, params, opt,
                                                         i))
            losses.append(float(loss))
            sil.append(float(terms["silhouette"]))
            counts.append(n)
            with_idx.append(self.driven["soft_mask_fwd_with_face_idx"])
            tex_counts.append({k: self.driven[k]
                               for k in (*TEXTURE_KERNELS, *REGATHER_KERNELS)})
        host_s = time.perf_counter() - t0
        end = [float(x) for x in ex.pose_error(scene, params)]
        peak = torch.cuda.max_memory_allocated() - base
        self.texfit.update(path_s=host_s, peak=peak, per_step=counts[-1],
                           losses=losses, sil=sil, start=start, end=end)
        every = all(all(c[k] > 0 for k in DIBR_KERNELS) for c in counts)
        self.check(every and with_idx == [c["soft_mask_fwd"] for c in counts],
                   f"texture fit: every one of {TEXFIT_PATH_STEPS} steps "
                   f"launched #1-3 (step 0 {counts[0]}, last {counts[-1]}; "
                   f"totals " + ", ".join(
                       f"{k} {sum(c[k] for c in counts)}"
                       for k in DIBR_KERNELS)
                   + "), the forward given the rasterizer's ids each time")
        once = {k: 1 for k in (*TEXTURE_KERNELS, *REGATHER_KERNELS)}
        self.check(all(c == once for c in tex_counts),
                   f"texture fit: every one of {TEXFIT_PATH_STEPS} steps "
                   f"sampled its texture through kernel #7 and re-gathered "
                   f"its winners through kernel #8, one launch each way "
                   f"(step 0 {tex_counts[0]}, last {tex_counts[-1]})")
        for k in (*TEXTURE_KERNELS, *REGATHER_KERNELS):
            self.results[k]["launches"] = tex_counts[-1][k]
            self.per_step[k] = tex_counts[-1][k]
        n = len(losses)
        self.check(all(np.isfinite(losses)),
                   "texture fit losses finite: " + ", ".join(
                       f"step {i} {losses[i]:.4f}"
                       for i in (0, n // 4, n // 2, n - 1)))
        self.check(sil[-1] <= 0.5 * sil[0],
                   f"texture fit silhouette term {sil[0]:.4f} -> "
                   f"{sil[-1]:.4f} (falls by at least half)")
        self.check(end[0] < start[0] and end[1] < start[1],
                   f"texture fit pose error falls: angle to the target "
                   f"{np.degrees(start[0]):.3f} -> {np.degrees(end[0]):.3f} "
                   f"deg, |t - t*| {start[1]:.4f} -> {end[1]:.4f}")
        print(f"texture fit path: {TEXFIT_PATH_STEPS} steps at {RES}x{RES}, "
              f"B=2, 4992 faces, 256x256 texture in {host_s:.2f} s host "
              f"with the set-up and a sync a step; peak memory "
              f"{peak / 2 ** 20:.1f} MiB above the "
              f"{base / 2 ** 20:.1f} MiB held before it [{self.card}]",
              flush=True)

    def phase_tutorials(self):
        """The two ported tutorials at their full sizes on the card, each
        asserting what its JAX counterpart asserts, every launch counter
        set to 0 just before each and read just after: the camera tutorial
        (256², an icosphere of 320 faces, 4 frames and a gradient) runs
        the winner search; the bounding-box fit (4 views at 128², 153 Adam
        steps) runs #1-3."""
        for name, kernels in (
                ("torch_tutorial_camera_rasterization", ("winner",)),
                ("torch_tutorial_bbox_fitting", DIBR_KERNELS)):
            mod = load_example(name)
            t0 = time.perf_counter()
            _, n = self.drive(DIBR_KERNELS, lambda: mod.main("cuda"))
            self.check(all(n[k] > 0 for k in kernels),
                       f"{name} at full size passed its checks in "
                       f"{time.perf_counter() - t0:.2f} s; launches {n}")

    def phase_texfit_timing(self):
        """The fit's step on the card: the median CUDA-event time event to
        event over steps 20-80 of one run from the start; then
        ``torch.profiler`` over 10 steps: device busy, idle share, the
        largest ops and #1-#3's device ms at this path's shapes."""
        torch, ex = self.torch, self.tex_ex
        scene = ex.texfit_setup(ex.texfit_inputs(), "cuda", RES)
        params = ex.initial_params(scene)
        opt = ex.make_optimizer(params)
        a, b = TEXFIT_TIMED
        events = []
        for i in range(b + 1):
            if i >= a:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            if i < b:
                ex.texfit_step(scene, params, opt, i)
        torch.cuda.synchronize()
        step_ms = statistics.median(x.elapsed_time(y) for x, y in
                                    zip(events[:-1], events[1:]))
        count = iter(range(b, 10 ** 6))
        busy, kernel_ms = self.profile_path(
            f"texture fit step ({RES}x{RES}, B=2)", DIBR_KERNELS,
            lambda: ex.texfit_step(scene, params, opt, next(count)),
            record=False)
        self.texfit.update(step_ms=step_ms, busy=busy, kernel_ms=kernel_ms)
        self.texfit_scatters(scene, params)
        self.texture_timing()
        print(f"texture fit step at {RES}x{RES}, B=2, 4992 faces, a "
              f"256x256 texture: steps {a}-{b} of one run, median event to "
              f"event {step_ms:.4f} ms ({1e3 / step_ms:.1f} steps/s); "
              f"device busy {busy:.4f} ms; #1-3 "
              + ", ".join(f"{k} {v:.4f}" for k, v in kernel_ms.items())
              + f" device ms a step [{self.card}]", flush=True)

    def texfit_scatters(self, scene, params):
        """The fit's two gathers alone, forward and backward, on its data
        (views 0 and 1 at the current state): the rasterizer's re-gather of
        the winners' vertices and features, and ``texture_mapping``'s four
        texel gathers at the rasterized UVs. Each one's device ms, and the
        part of it in the colliding scatter-add of its backward."""
        torch = self.torch
        from kaolin_tpu_torch.render.mesh import (
            prepare_vertices,
            texture_mapping,
        )
        uvs = scene["face_uvs"].expand(2, -1, -1, -1)
        feats = torch.cat([uvs, torch.ones_like(uvs[..., :1])], -1)
        with torch.no_grad():
            v = self.tex_ex.posed_vertices(scene["template"], params)
            fvc, fvi, normals = prepare_vertices(
                v[None], scene["faces"], scene["proj"],
                camera_transform=scene["cams"][[0, 1]])
            image, idx = self.rast.rasterize(RES, RES, fvc[..., 2], fvi,
                                             feats,
                                             valid_faces=normals[..., 2] >= 0)
        scaled = (fvi * 1000.0).requires_grad_(True)
        feats = feats.clone().requires_grad_(True)
        uv = image[..., :2].clone().requires_grad_(True)
        tex = params["texture"].detach().clone().requires_grad_(True)
        cases = {
            f"re-gather (2 x {RES}² winners, 4992 x 3 x 3 features)":
                lambda: self.rast._interpolate_at_winners(
                    idx, scaled, feats, 1000, 1e-8).sum().backward(),
            f"texture_mapping (2 x {RES}² UVs, 3 x 256² texture)":
                lambda: texture_mapping(
                    uv, tex[None].expand(2, -1, -1, -1),
                    "bilinear").sum().backward()}
        for label, fn in cases.items():
            events = self.device_events(label, fn, 10)
            total = sum(us for _, us in events) / 10 / 1e3
            scatter = sum(us for name, us in events
                          if "scatter" in name and "ReduceAdd" in name) \
                / 10 / 1e3
            self.texfit[label] = (total, scatter)
            print(f"texture fit's {label}: forward and backward "
                  f"{total:.4f} device ms, {scatter:.4f} of it in the "
                  f"backward's scatter-add [{self.card}]", flush=True)

    def texture_timing(self):
        """Kernel #7 at both cells' shapes (8 x 512² UVs sliced from a
        feature image, one shared texture, bilinear), forward and backward
        apart: its device ms in a profile (the zero-fill counted in the
        backward's), the CUDA-event ms of one call against its plain
        version's (plain, kernel, kernel, plain) and against
        ``torch.nn.functional.grid_sample``'s (border padding,
        align_corners False; the library yardstick, timed here and never
        called by the port), and the bytes bound. The kernel table's row
        is texfit.v8's."""
        torch, tm = self.torch, self.mesh_utils
        grid_sample = torch.nn.functional.grid_sample
        for cell, side in TEXTURE_SIDES.items():
            case = self.texture_case(TEXTURE_VIEWS, side, 40)
            feats = case["feats"].requires_grad_(True)
            tex = case["tex"].requires_grad_(True)
            uv = torch.split(feats, [2, 1], dim=-1)[0]
            batch = tex[None].expand(TEXTURE_VIEWS, -1, -1, -1)
            with torch.no_grad():
                grid = (uv.clamp(0, 1) * 2 - 1) * uv.new_tensor([1.0, -1.0])
            grid.requires_grad_(True)
            cot = case["cot"]
            calls = {   # name: (forward, inputs, cotangent)
                "kernel": (lambda: tm.texture_mapping(uv, batch, "bilinear"),
                           (feats, tex), cot),
                "plain": (lambda: tm.texture_mapping_plain(
                    uv.reshape(TEXTURE_VIEWS, -1, 2), batch, "bilinear"),
                    (feats, tex), cot.reshape(TEXTURE_VIEWS, -1, 3)),
                "library": (lambda: grid_sample(
                    batch, grid, mode="bilinear", padding_mode="border",
                    align_corners=False), (tex, grid),
                    cot.permute(0, 3, 1, 2))}
            ms = {}
            for name, (fwd, inputs, g) in calls.items():
                out = fwd()

                def bwd(out=out, inputs=inputs, g=g):
                    return torch.autograd.grad(out, inputs, g,
                                               retain_graph=True)
                ms[name] = {"fwd": fwd, "bwd": bwd}
            times = {}
            for way in ("fwd", "bwd"):
                k_ms, p_ms = self.compare_times(ms["kernel"][way],
                                                ms["plain"][way], 20, 5)
                lib_ms = statistics.median(self.time_ms(ms["library"][way],
                                                        20))
                lib_dev = self.device_ms(f"grid_sample {way} {cell}",
                                         ms["library"][way])
                times[way] = [None, k_ms, p_ms, lib_ms, lib_dev]
            # the kernel's forward and backward in one trace (3 launches a
            # call): the forward alone, 1 launch a call, once came back from
            # the profiler without device time in three traces in a row
            for way in times:
                times[way][0] = self.device_ms(
                    f"texture kernel {cell}",
                    lambda: (ms["kernel"]["fwd"](), ms["kernel"]["bwd"]()),
                    names=DEVICE_NAMES[f"texture_{way}"],
                    alone=ms["kernel"][way])
            p = TEXTURE_VIEWS * RES * RES
            tex_bytes = 3 * side * side * 4
            nbytes = {"fwd": p * 8 + tex_bytes + p * 12,
                      "bwd": p * 12 + p * 8 + tex_bytes + p * 8 + tex_bytes}
            for way, (dev, k_ms, p_ms, lib_ms, lib_dev) in times.items():
                bound = nbytes[way] / HBM_BYTES_S * 1e3
                print(f"texture kernel {way} [{cell}: {TEXTURE_VIEWS} x "
                      f"{RES}² UVs, 3 x {side}² shared texture]: device "
                      f"{fmt_ms(dev)} ms, event {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, grid_sample event {lib_ms:.4f} ms "
                      f"(device {fmt_ms(lib_dev)}); bound {bound:.6f} ms "
                      f"({nbytes[way]} bytes), share "
                      f"{fmt_ms(dev and bound / dev)} [{self.card}]",
                      flush=True)
                if cell == "texfit.v8":
                    k = f"texture_{way}"
                    self.results[k].update(device_ms=dev, ms=k_ms,
                                           plain_ms=p_ms, library_ms=lib_dev)
                    self.set_bound(k, nbytes[way], 0,
                                   f"{cell}'s shapes, each byte once")

    # -- the SPC raster ----------------------------------------------------
    def config3(self):
        """Config 3 built once: (rspc, camera, (tile_px, s_max, c_cap))."""
        if self._config3 is None:
            ex = self.spc_ex
            rspc, cam, _ = ex.build_scene(ex.config3_inputs(SPC_LEVEL),
                                          self.device, SPC_RES)
            caps, _ = ex.grow_caps(rspc, cam)
            self._config3 = rspc, cam, caps
        return self._config3

    def spc_camera(self, eye, res, fov):
        return self.Camera.from_args(
            eye=self.torch.tensor(eye), at=self.torch.zeros(3),
            up=self.torch.tensor([0.0, 1.0, 0.0]), fov=fov, width=res,
            height=res, device=self.device)

    def spc_bins(self, rspc, cam, caps):
        """The binning of one frame and the camera vector → dict of the
        tile kernel's inputs."""
        tile_px, s_max, c_cap = caps
        params = self.sr._prep_camera(cam)
        tab, counts, dz, ov = self.sr._bin_units(
            rspc.uaabb, *params, width=cam.width, height=cam.height,
            tile_h=tile_px, tile_w=tile_px, s_max=s_max, c_cap=c_cap)
        return {"tab": tab, "counts": counts, "dz": dz, "overflow": ov,
                "cam": self.sr._camera_vector(*params),
                "size": dict(width=cam.width, height=cam.height,
                             tile_px=tile_px)}

    def spc_tiles(self, kernel, rspc, b):
        fn = (self.craster.raster_tiles_cuda if kernel
              else self.sr.raster_tiles_plain)
        return fn(b["tab"], b["counts"], b["dz"], b["cam"], rspc.l3boxes,
                  rspc.units, rspc.uaabb, **b["size"])

    def spc_plain_frame(self, rspc, cam, caps):
        """raster_first_hit with the plain versions in place of the
        kernels."""
        b = self.spc_bins(rspc, cam, caps)
        depth, ids = self.sr.untile_plain(*self.spc_tiles(False, rspc, b),
                                          **b["size"])
        return self.sr._finish(depth, ids, b["overflow"])

    def spc_oracle(self, rspc, cam, pix):
        """Every leaf slab-tested against the rays of pixels ``pix``, with
        the raster's ray and slab formulas but no binning → (depth, id,
        leaf boxes by point-hierarchy id, first id), 3e38 and -1 on a
        miss."""
        torch, sr = self.torch, self.sr
        res = cam.width
        cam_vec = sr._camera_vector(*sr._prep_camera(cam))
        origin, inv = sr._rays(cam_vec, pix // res, pix % res, res,
                               cam.height)
        lanes = rspc.units.permute(0, 2, 1).reshape(-1, 8)
        lanes = lanes[lanes[:, 0] < 1.0e38].contiguous()
        ids = lanes[:, 6].contiguous().view(torch.int32)
        n = pix.shape[0]
        best = torch.full((n,), 3.0e38, device=pix.device)
        best_id = torch.full((n,), 2 ** 30, dtype=torch.int32,
                             device=pix.device)
        for s in range(0, lanes.shape[0], 8192):
            chunk = lanes[s:s + 8192]
            t_in, _, hit = sr._slab([chunk[:, k] for k in range(3)],
                                    [chunk[:, 3 + k] for k in range(3)],
                                    origin, [i[:, None] for i in inv])
            cand = torch.where(hit, t_in, 3.0e38)
            m = cand.amin(dim=1)
            sel = torch.where(cand == m[:, None], ids[None, s:s + 8192],
                              2 ** 30).amin(dim=1)
            best_id = torch.where(m < best, sel, torch.where(
                m == best, torch.minimum(best_id, sel), best_id))
            best = torch.minimum(best, m)
        first = int(ids.min())
        boxes = torch.empty((lanes.shape[0], 6), device=pix.device)
        boxes[(ids - first).long()] = lanes[:, :6]
        return best, torch.where(best < 1.0e38, best_id, -1), boxes, first

    def check_oracle(self, rspc, cam, t, nidx, label):
        """The raster's frame against the brute-force oracle on
        ORACLE_PIXELS pixels drawn with a seeded generator: equal hits,
        bitwise equal depths, and where the ids differ, a tie in depth."""
        torch = self.torch
        res = cam.width
        pix = torch.from_numpy(np.random.default_rng(0).choice(
            res * cam.height, ORACLE_PIXELS, replace=False)).to(self.device)
        depth_o, id_o, boxes, first = self.spc_oracle(rspc, cam, pix)
        t_r, id_r = t[pix], nidx[pix]
        hit_o, hit_r = depth_o < 1.0e38, torch.isfinite(t_r)
        same_hits = bool((hit_o == hit_r).all())
        bitwise = bool((t_r[hit_r].view(torch.int32)
                        == depth_o[hit_r].view(torch.int32)).all())
        differ = hit_r & (id_r != id_o)
        ties = True
        if bool(differ.any()):
            cam_vec = self.sr._camera_vector(*self.sr._prep_camera(cam))
            q = pix[differ]
            origin, inv = self.sr._rays(cam_vec, q // res, q % res, res,
                                        cam.height)
            box = boxes[(id_r[differ] - first).long()]
            t_in, _, hit = self.sr._slab([box[:, k] for k in range(3)],
                                         [box[:, 3 + k] for k in range(3)],
                                         origin, inv)
            ties = bool((hit & (t_in == depth_o[differ])).all())
        self.check(same_hits and bitwise and ties and int(hit_r.sum()) > 0,
                   f"SPC raster vs brute-force oracle [{label}], "
                   f"{ORACLE_PIXELS} pixels: {int(hit_r.sum())} hit, hits "
                   f"equal {same_hits}, depths bitwise {bitwise}, "
                   f"{int(differ.sum())} ids differ, all ties {ties}")

    def phase_spc_parity(self):
        torch = self.torch
        blobs = self.spc_ex.build_scene(
            {"points": blob_points(), "level": 5,
             "eye": np.float32([1.5, 0.9, -1.2]), "at": np.zeros(3, "f4"),
             "up": np.float32([0, 1, 0]), "fov": 0.9}, self.device, 64)[:2]
        caps, _ = self.spc_ex.grow_caps(*blobs, caps=(8, 16, 128))
        rspc3, cam3, caps3 = self.config3()
        inside = self.spc_camera(list(INSIDE_EYE), SPC_RES, 0.8)
        caps_in, _ = self.spc_ex.grow_caps(rspc3, inside)
        for label, (rspc, cam, caps) in (
                (f"blobs L5 64x64, caps {caps}", (*blobs, caps)),
                (f"config 3 L{SPC_LEVEL} {SPC_RES}x{SPC_RES}, caps {caps3}",
                 (rspc3, cam3, caps3)),
                (f"inside the shell {SPC_RES}x{SPC_RES}, caps {caps_in}",
                 (rspc3, inside, caps_in))):
            b = self.spc_bins(rspc, cam, caps)
            dk, ik = self.spc_tiles(True, rspc, b)
            dp, ip = self.spc_tiles(False, rspc, b)
            same = bool((dk.view(torch.int32) == dp.view(torch.int32)).all())
            bad = int((ik != ip).sum())
            hits = int((dp < 1.0e38).sum())
            self.check(same and bad == 0 and hits > 0 and
                       all(int(v) == 0 for v in b["overflow"].values()),
                       f"spc_raster vs plain [{label}]: depths bitwise "
                       f"{same}, {bad} ids differ, {hits} pixels hit")
            self.record_err("spc_raster", max(float((dk - dp).abs().max()),
                                              float((ik - ip).abs().max())))
            uk = self.craster.untile_cuda(dk, ik, **b["size"])
            up = self.sr.untile_plain(dk, ik, **b["size"])
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(uk, up))
            self.check(same, f"spc_untile vs plain [{label}]: bitwise {same}")
            self.record_err("spc_untile", max(
                float((uk[0] - up[0]).abs().max()),
                float((uk[1] - up[1]).abs().max())))
        # F13: a 32-px tile is split into 16-px ones on the card too
        kw = dict(s_max=caps3[1], c_cap=caps3[2])
        t32 = self.sr.raster_first_hit(rspc3, cam3, tile_px=32, **kw)
        t16 = self.sr.raster_first_hit(rspc3, cam3, tile_px=16, **kw)
        same = (torch.equal(t32[0].view(torch.int32),
                            t16[0].view(torch.int32))
                and torch.equal(t32[1], t16[1]) and bool(t32[2].any()))
        self.check(same, f"F13: raster_first_hit with tile_px 32 on the card"
                   f" equals tile_px 16 at config 3 bit for bit: {same}")
        torch.cuda.synchronize()

    def phase_spc_main_path(self):
        torch = self.torch
        out, launches = self.drive(SPC_KERNELS, lambda: self.spc_ex.
                                   config3_frames(self.device, SPC_RES,
                                                  SPC_FRAMES, SPC_LEVEL))
        t, nidx, valid = out["depth"], out["nidx"], out["valid"]
        print(f"config3_frames L{SPC_LEVEL} {SPC_RES}x{SPC_RES}, "
              f"{SPC_FRAMES} frames: caps (tile_px, s_max, c_cap) "
              f"{out['caps']}, overflow {out['overflow']}, "
              f"{int(valid[0].sum())} pixels hit; launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"main path launched {k} ({n} times)")
        self.check(all(v == 0 for v in out["overflow"].values()),
                   f"config-3 overflow after growth {out['overflow']}")
        hw = SPC_RES * SPC_RES
        self.check(t.shape == (SPC_FRAMES, hw) and nidx.shape == t.shape
                   and bool(valid.any(dim=1).all())
                   and bool(torch.isfinite(t[valid]).all())
                   and bool((t[valid] > 0).all())
                   and bool((nidx[~valid] == -1).all()),
                   f"config-3 frames of shape {tuple(t.shape)}: finite "
                   "positive depths where hit, -1 ids where missed")
        self.check(bool((t == t[0]).all() and (nidx == nidx[0]).all()),
                   "config-3 frames of one camera are identical")

        rspc, cam, caps = out["rspc"], out["camera"], out["caps"]
        tp, ip, vp, _ = self.spc_plain_frame(rspc, cam, caps)
        same = bool((t[0].view(torch.int32) == tp.view(torch.int32)).all()
                    and (nidx[0] == ip).all() and (valid[0] == vp).all())
        self.check(same, "config-3 frame 0 through the kernels equals the "
                   "plain frame bit for bit")
        self.check_oracle(rspc, cam, t[0], nidx[0], f"config 3 {SPC_RES}²")

        inside = self.spc_camera(list(INSIDE_EYE), SPC_RES, 0.8)
        caps_in, (ti, ii, vi, ov) = self.spc_ex.grow_caps(rspc, inside)
        tp, ip, vp, _ = self.spc_plain_frame(rspc, inside, caps_in)
        same = bool((ti.view(torch.int32) == tp.view(torch.int32)).all()
                    and (ii == ip).all())
        # the shell's random points leave some cells empty, so a few rays
        # escape: the oracle below checks each sampled pixel
        ov = {k: int(v) for k, v in ov.items()}
        self.check(caps_in[1] > caps[1] and same and bool(vi.any()),
                   f"camera inside the shell at {SPC_RES}²: caps grew to "
                   f"{caps_in}, overflow {ov}, {int(vi.sum())} pixels hit, "
                   f"kernels equal the plain frame {same}")
        self.check_oracle(rspc, inside, ti, ii, f"inside {SPC_RES}²")

    def phase_spc_timing(self):
        torch = self.torch
        print(f"timing on {self.card}", flush=True)
        rspc, cam, caps = self.config3()
        b = self.spc_bins(rspc, cam, caps)
        dt, it = self.spc_tiles(True, rspc, b)
        size = b["size"]
        bins_ms = statistics.median(self.time_ms(
            lambda: self.spc_bins(rspc, cam, caps), 20))
        print(f"SPC binning (plain torch) at config 3: {bins_ms:.4f} ms")
        pairs = {
            "spc_raster": (lambda: self.spc_tiles(True, rspc, b),
                           lambda: self.spc_tiles(False, rspc, b), 20, 3),
            "spc_untile": (lambda: self.craster.untile_cuda(dt, it, **size),
                           lambda: self.sr.untile_plain(dt, it, **size), 50,
                           20),
        }
        for name, (kern, plain, reps, plain_reps) in pairs.items():
            k_ms, p_ms = self.compare_times(kern, plain, reps, plain_reps)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name} at config 3 (L{SPC_LEVEL}, {SPC_RES}², caps "
                  f"{caps}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms",
                  flush=True)
        tile_px, s_max, c_cap = caps
        kw = dict(tile_px=tile_px, s_max=s_max, c_cap=c_cap)
        k_ms, p_ms = self.compare_times(
            lambda: self.sr.raster_first_hit(rspc, cam, **kw),
            lambda: self.spc_plain_frame(rspc, cam, caps), 20, 3)
        print(f"config-3 frame at {SPC_RES}²: kernels {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms [{self.card}]", flush=True)
        seq_ms = statistics.median(self.time_ms(
            lambda: self.sr.raster_first_hit_sequence(
                rspc, [cam] * SPC_FRAMES, **kw), 3))
        print(f"config-3 sequence of {SPC_FRAMES} frames at {SPC_RES}²: "
              f"{seq_ms:.4f} ms, {seq_ms / SPC_FRAMES:.4f} ms/frame "
              f"[{self.card}]", flush=True)

    # -- config 3 as written: mesh → SPC → raytrace ------------------------
    def rel_err(self, a, b):
        """max|a − b| over max(1, max|b|), in float64 on the host."""
        a = a.detach().double().cpu()
        b = b.detach().double().cpu()
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    def grad_err(self, a, b):
        """max|a − b| over max|b|, in float64 on the host."""
        a = a.detach().double().cpu()
        b = b.detach().double().cpu()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def packed_ops_case(self, nuggets, device):
        """Every packed op on the nuggets' packs, with seeded features and
        the nuggets' optical thickness, and their gradients under a seeded
        cotangent → {name: (value, gradient)} on the host."""
        torch, rt = self.torch, self.rt
        ridx, _, t = (x.to(device) for x in nuggets)
        rng = np.random.RandomState(11)
        feats0 = torch.from_numpy(rng.uniform(
            0.2, 1.5, (len(ridx), 3)).astype(np.float32)).to(device)
        tau0 = (t[:, 1:] - t[:, :1]) * 50.0
        b = rt.mark_pack_boundaries(ridx)
        ops = {f"{op}{'_excl' if ex else ''}{'_rev' if rev else ''}":
               (lambda x, op=op, ex=ex, rev=rev: getattr(rt, op)(
                   x, b, exclusive=ex, reverse=rev))
               for op in ("cumsum", "cumprod") for ex in (False, True)
               for rev in (False, True)}
        ops.update(sum_reduce=lambda x: rt.sum_reduce(x, b),
                   prod_reduce=lambda x: rt.prod_reduce(x, b),
                   diff=lambda x: rt.diff(x, b),
                   exponential_integration=lambda x: torch.cat(
                       [o.reshape(-1) for o in rt.exponential_integration(
                           x, tau0, b)]))
        out = {"boundaries": (b.cpu(), None)}
        for name, fn in ops.items():
            x = feats0.clone().requires_grad_(True)
            y = fn(x)
            w = torch.from_numpy(np.random.RandomState(12).randn(
                *y.shape).astype(np.float32)).to(device)
            (y * w).sum().backward()
            out[name] = (y.detach().cpu(), x.grad.cpu())
        return out

    def nglod_case(self, scene, rays, dtype=None, nuggets=None, keep=False):
        """The fit's first step on one view at full width (32-wide
        features, a hidden layer of 128): the teacher's target, the
        student's render, loss and gradients → dict on the host. With
        ``nuggets`` (``trace``'s output, on any device) both renders take
        them in place of the scene's own traversal. With ``dtype`` the
        fields, rays and depths are cast to it after the float32 traversal
        (the same nuggets). With ``keep`` it also returns, as ``inter``,
        what enters the backward's two sums over the nuggets: the sample
        points x, the leaves, the decoder's input f and the gradients at f,
        at the first layer's output h and at the image, the decoder's
        output and each nugget's depth t_out − t_in."""
        torch, ex = self.torch, self.rt_ex
        st = ex.fit_setup(scene, [rays])
        device = scene["octree"].device
        given = nuggets is not None
        nuggets = (tuple(x.to(device) for x in nuggets) if given
                   else ex.trace(scene, rays))
        if dtype is not None:
            for field in (st["teacher"], st["student"]):
                field["features"] = field["features"].detach().to(dtype)
                field["decoder"] = field["decoder"].to(dtype)
            st["student"]["features"].requires_grad_(True)
            rays = tuple(x.to(dtype) for x in rays)
            nuggets = (*nuggets[:2], nuggets[2].to(dtype))
        if dtype is not None or given:
            with torch.no_grad():
                st["targets"] = [ex.nglod_render(scene, st["teacher"], rays,
                                                 nuggets)]
        kept = {}

        def hook(module, inputs, output):
            inputs[0].retain_grad()
            output.retain_grad()
            kept.update(f=inputs[0], h=output)

        def keep_out(module, inputs, output):
            kept.update(out=output)

        decoder = st["student"]["decoder"]
        handles = ([decoder[0].register_forward_hook(hook),
                    decoder.register_forward_hook(keep_out)] if keep else [])
        image = ex.nglod_render(scene, st["student"], rays, nuggets)
        for handle in handles:
            handle.remove()
        if keep:
            image.retain_grad()
        loss = ((image - st["targets"][0]) ** 2).mean()
        loss.backward()
        lin = [m for m in st["student"]["decoder"]
               if isinstance(m, torch.nn.Linear)]
        grads = {"features": st["student"]["features"].grad}
        for i, m in enumerate(lin):
            grads[f"w{i}"], grads[f"b{i}"] = m.weight.grad, m.bias.grad
        out = {"target": st["targets"][0].cpu(), "image": image.detach().cpu(),
               "loss": float(loss.detach()),
               "grads": {k: v.cpu() for k, v in grads.items()}}
        if keep:
            r, t = nuggets[0].long(), nuggets[2]
            with torch.no_grad():   # x as nglod_render takes it
                x = rays[0][r] + (0.5 * (t[:, 0] + t[:, 1]))[:, None] \
                    * rays[1][r]
            out["inter"] = {"x": x.cpu(), "pidx": nuggets[1].cpu(),
                            "out": kept["out"].detach().cpu(),
                            "dt": (t[:, 1] - t[:, 0]).cpu(),
                            "f": kept["f"].detach().cpu(),
                            "g_f": kept["f"].grad.cpu(),
                            "g_h": kept["h"].grad.cpu(),
                            "g_image": image.grad.cpu()}
        return out

    def replay_sums(self, scene, inter, dtype):
        """The nglod backward's two sums over the nuggets, replayed on the
        CPU in ``dtype`` from ``inter`` (``nglod_case``'s, from either
        device): the first layer's weight gradient g_hᵀ f, and the
        features' gradient, each nugget's trilinear coefficients times g_f
        added into its 8 corners at each of the three LODs (the backward of
        ``feats[trinkets[pidx]]``, an ``index_put_`` that accumulates, whose
        adds collide on the card) → {"w0", "features"}."""
        torch, ex = self.torch, self.rt_ex
        from kaolin_tpu_torch.ops.spc import coords_to_trilinear_coeffs
        g_f = inter["g_f"].to(dtype)
        x = inter["x"].to(dtype)[:, None]
        feats = torch.zeros((scene["dual"].shape[0], g_f.shape[1]),
                            dtype=dtype)
        p = inter["pidx"].long()
        for lod in range(scene["level"], scene["level"] - ex.LODS, -1):
            cell = scene["point_hierarchy"][p].to(dtype)[:, None]
            coeffs = coords_to_trilinear_coeffs(x, cell, lod)[:, 0]
            feats.index_put_((scene["trinkets"][p].long(),),
                             coeffs[:, :, None] * g_f[:, None, :],
                             accumulate=True)
            p = scene["parents"][p].long()
        return {"w0": inter["g_h"].to(dtype).T @ inter["f"].to(dtype),
                "features": feats}

    def nglod_sources(self, card, cpu, rays_c, rays_h, nug_h, nh):
        """Where the nglod gradients part between the card and the CPU.
        The card's step is taken again from the CPU's nuggets (the same
        inputs, so only the two devices' float32 arithmetic differs) and,
        in float64, from the same nuggets on both devices (a check that
        both compute one function). For the two leaves whose gradients are
        sums over the nuggets, ``features`` and ``w0``, the sum is replayed
        on the CPU from the card's own inputs to it: ``op`` is the card's
        sum against the CPU's on the card's inputs, ``upstream`` the CPU's
        sum on the card's inputs against the CPU's gradient, ``own`` the
        CPU's float32 sum against float64 on the same inputs; ``replay``
        checks that the replay on the CPU's inputs gives the CPU's
        gradient. ``alpha`` reads the render's 1 − exp(−τ) on both
        devices from the CPU's τ, and how far the residual I − I* magnifies
        the image's error (max|I| / max|I − I*|). ``pinned`` is the card's
        float32 step from the same nuggets with every ``torch.exp`` of the
        render, forward and backward, taken on the CPU → dict of
        readings."""
        torch = self.torch
        f32, f64 = torch.float32, torch.float64
        ns = self.nglod_case(card, rays_c, nuggets=nug_h, keep=True)
        exact_h = self.nglod_case(cpu, rays_h, f64, nuggets=nug_h)
        exact_c = self.nglod_case(card, rays_c, f64, nuggets=nug_h)
        same = {k: self.grad_err(v, nh["grads"][k])
                for k, v in ns["grads"].items()}
        f64_err = {k: self.grad_err(v, exact_h["grads"][k])
                   for k, v in exact_c["grads"].items()}
        f64_err["loss"] = (abs(exact_c["loss"] - exact_h["loss"])
                           / abs(exact_h["loss"]))
        inputs = {k: self.grad_err(ns["inter"][k], nh["inter"][k])
                  for k in ("g_image", "g_h", "g_f", "f")}
        rep_h = self.replay_sums(cpu, nh["inter"], f32)
        rep_c = self.replay_sums(cpu, ns["inter"], f32)
        rep_c64 = self.replay_sums(cpu, ns["inter"], f64)
        sums = {k: {"replay": self.grad_err(rep_h[k], nh["grads"][k]),
                    "op": self.grad_err(ns["grads"][k], rep_c[k]),
                    "upstream": self.grad_err(rep_c[k], nh["grads"][k]),
                    "own": self.grad_err(rep_c[k], rep_c64[k]),
                    "card_own": self.grad_err(ns["grads"][k], rep_c64[k])}
                for k in rep_h}
        # the render's alpha 1 − exp(−τ) from the CPU's τ on both devices:
        # exp's results in units of their last place, and alpha relative
        tau = (torch.nn.functional.softplus(nh["inter"]["out"][:, 0])
               * nh["inter"]["dt"])
        e_h = torch.exp(-tau)
        e_c = torch.exp(-tau.to(card["octree"].device)).cpu()
        ulp = torch.nextafter(e_h, torch.full_like(e_h, 2.0)) - e_h
        a_h, pos = 1.0 - e_h, tau > 0
        alpha = {"tau_median": float(tau[pos].median()),
                 "exp_ulps": float(((e_c - e_h).abs() / ulp).max()),
                 "exp_differ": float((e_c != e_h).double().mean()),
                 "rel": float(((1.0 - e_c) - a_h)[pos].abs().div(
                     a_h[pos]).max())}
        image = nh["image"]
        alpha["residual"] = float(image.abs().max()
                                  / (image - nh["target"]).abs().max())
        real_exp = torch.exp

        def host_exp(x):   # the CPU's exp, and so its backward's result
            return real_exp(x.cpu()).to(x.device)

        torch.exp = host_exp
        try:
            pinned = self.nglod_case(card, rays_c, nuggets=nug_h)
        finally:
            torch.exp = real_exp
        pinned = {k: self.grad_err(v, nh["grads"][k])
                  for k, v in pinned["grads"].items()}
        return {"same_nuggets": same, "float64": f64_err, "inputs": inputs,
                "sums": sums, "alpha": alpha, "pinned": pinned}

    def phase_spcrt_parity(self):
        """Config 3 as written on the card against the port on the CPU at
        level 7 and 128²: the octree, the dual and the trinkets equal; view
        0's nugget stream equal with depths within 1e-6; the frontier's
        level counts equal; every packed op within 1e-6 relative and its
        gradient within 1e-5 of max|g|; the nglod-style render, loss and
        gradients of the fit's first step within 1e-5 of max|g|, except
        ``features`` and ``w0``, held to 1e-5 or 0.1 of the CPU float32
        gradient's own distance from the same step in float64, whichever is
        larger: ``nglod_sources`` reads where card and CPU part (the exp
        in alpha = 1 − exp(−τ), not the sums over the nuggets), and with
        the render's exp taken on the CPU holds all five gradients to
        1e-5. Both devices' steps in float64 from the same nuggets agree
        within 1e-10."""
        torch, ex, rt = self.torch, self.rt_ex, self.rt
        level, res = SPCRT_PARITY
        card, cpu = ex.spc_scene(level, "cuda"), ex.spc_scene(level, "cpu")
        for key in ("octree", "exsum", "pyramid", "point_hierarchy", "dual",
                    "pyramid_dual", "trinkets", "parents"):
            a, b = card[key].cpu(), cpu[key]
            self.check(a.dtype == b.dtype and torch.equal(a, b),
                       f"spcrt parity L{level}: {key} card = CPU "
                       f"{tuple(b.shape)}")
        rays_c, rays_h = (ex.view_rays(0, res, d) for d in ("cuda", "cpu"))
        nug_c, nug_h = ex.trace(card, rays_c), ex.trace(cpu, rays_h)
        t_err = float((nug_c[2].cpu() - nug_h[2]).abs().max())
        self.check(torch.equal(nug_c[0].cpu(), nug_h[0])
                   and torch.equal(nug_c[1].cpu(), nug_h[1])
                   and t_err <= SPCRT_TOL["t"],
                   f"spcrt parity {res}²: {len(nug_h[0])} nuggets, ridx and "
                   f"pidx card = CPU, t_in/t_out max err {t_err:.3g}")
        counts = [rt._raytrace_frontier(sc["octree"], sc["exsum"], *r, level,
                                        4 * res * res)[5].tolist()
                  for sc, r in ((card, rays_c), (cpu, rays_h))]
        self.check(counts[0] == counts[1],
                   f"spcrt parity: frontier level counts card = CPU "
                   f"{counts[1]}")
        pc, ph = (self.packed_ops_case(nug_h, d) for d in ("cuda", "cpu"))
        self.check(torch.equal(pc["boundaries"][0], ph["boundaries"][0]),
                   "spcrt parity: pack boundaries card = CPU")
        worst = {}
        for name in ph:
            if name == "boundaries":
                continue
            v_err = self.rel_err(pc[name][0], ph[name][0])
            g_err = self.grad_err(pc[name][1], ph[name][1])
            worst[name] = (v_err, g_err)
            self.check(v_err <= SPCRT_TOL["rel"]
                       and g_err <= SPCRT_TOL["grad"],
                       f"spcrt parity: {name} value err {v_err:.3g}, "
                       f"gradient err {g_err:.3g} of max|g|")
        nc = self.nglod_case(card, rays_c)
        nh = self.nglod_case(cpu, rays_h, keep=True)
        exact = self.nglod_case(cpu, rays_h, torch.float64)
        errs = {"target": self.rel_err(nc["target"], nh["target"]),
                "image": self.rel_err(nc["image"], nh["image"]),
                "loss": abs(nc["loss"] - nh["loss"]) / abs(nh["loss"])}
        errs.update({k: self.grad_err(nc["grads"][k], v)
                     for k, v in nh["grads"].items()})
        # float32's own error: the CPU's float32 gradients against the same
        # step in float64
        own = {k: self.grad_err(v, exact["grads"][k])
               for k, v in nh["grads"].items()}
        bound = {k: SPCRT_TOL["grad"] for k in errs}
        for k in SPCRT_SUMS:
            bound[k] = max(SPCRT_TOL["grad"], SPCRT_TOL["own"] * own[k])
        self.check(all(errs[k] <= bound[k] for k in errs),
                   "spcrt parity: nglod render, loss and gradients card vs "
                   "CPU " + ", ".join(f"{k} {v:.3g} (bound {bound[k]:.3g})"
                                      for k, v in errs.items()))
        print("  float32's own gradient error against float64 on the CPU: "
              + ", ".join(f"{k} {v:.3g}" for k, v in own.items()))
        src = self.nglod_sources(card, cpu, rays_c, rays_h, nug_h, nh)
        self.check(all(v <= bound[k] for k, v in src["same_nuggets"].items()),
                   "spcrt parity: nglod gradients card vs CPU from the same "
                   "nuggets " + ", ".join(
                       f"{k} {v:.3g} (bound {bound[k]:.3g})"
                       for k, v in src["same_nuggets"].items()))
        self.check(all(v["op"] <= SPCRT_TOL["grad"]
                       for v in src["sums"].values()),
                   "spcrt parity: the sums over the nuggets, card vs CPU on "
                   "the card's inputs " + ", ".join(
                       f"{k} {v['op']:.3g}" for k, v in src["sums"].items())
                   + f" (bound {SPCRT_TOL['grad']:g})")
        self.check(all(v <= SPCRT_TOL["f64"]
                       for v in src["float64"].values()),
                   "spcrt parity: nglod step in float64 card vs CPU from "
                   "the same nuggets " + ", ".join(
                       f"{k} {v:.3g}" for k, v in src["float64"].items())
                   + f" (bound {SPCRT_TOL['f64']:g})")
        self.check(all(v <= SPCRT_TOL["grad"]
                       for v in src["pinned"].values()),
                   "spcrt parity: with the render's exp on the CPU, nglod "
                   "gradients card vs CPU from the same nuggets " + ", ".join(
                       f"{k} {v:.3g}" for k, v in src["pinned"].items())
                   + f" (bound {SPCRT_TOL['grad']:g})")
        self.check(all(v["replay"] <= SPCRT_TOL["replay"]
                       for v in src["sums"].values()),
                   "spcrt parity: the replayed sums give the CPU's "
                   "gradients " + ", ".join(
                       f"{k} {v['replay']:.3g}"
                       for k, v in src["sums"].items())
                   + f" (bound {SPCRT_TOL['replay']:g})")
        print("  from the same nuggets, the card's inputs to the sums "
              "against the CPU's: " + ", ".join(
                  f"{k} {v:.3g}" for k, v in src["inputs"].items()))
        for k, v in src["sums"].items():
            print(f"  {k}'s sum from the same nuggets: card's sum vs the "
                  f"CPU's on the card's inputs {v['op']:.3g}, the CPU's sum "
                  f"on the card's inputs vs the CPU's gradient "
                  f"{v['upstream']:.3g}; against float64 on the card's "
                  f"inputs: the CPU's float32 sum {v['own']:.3g}, the "
                  f"card's {v['card_own']:.3g}")
        a = src["alpha"]
        print(f"  alpha = 1 - exp(-tau) from the CPU's tau (median "
              f"{a['tau_median']:.3g}): exp card vs CPU at most "
              f"{a['exp_ulps']:g} ulp, differing at {a['exp_differ']:.4f} of "
              f"the nuggets; alpha card vs CPU {a['rel']:.3g} relative; "
              f"max|I| / max|I - I*| {a['residual']:.4g}")
        self.spcrt["parity"] = {"packed": worst, "nglod": errs, "own": own,
                                "t_err": t_err, "sources": src}

    def phase_spcrt_path(self):
        """Config 3 as written at full width on the card, every launch
        counter set to 0 just before and read just after: the mesh → SPC at
        level 9, the dual and trinkets, the 8 views' rays, view 0's depth
        render, the teacher's targets and 50 fit steps. No kernel may
        launch; the integers are the JAX package's; the mean loss over steps
        41-50 is below 0.7 of that over steps 1-10."""
        torch, ex, rt = self.torch, self.rt_ex, self.rt
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def path():
            scene = ex.spc_scene(SPCRT_LEVEL, "cuda")
            views = [ex.view_rays(k, SPCRT_RES, "cuda")
                     for k in range(ex.VIEWS)]
            frame = ex.depth_render(scene, views[0])
            state = ex.fit_setup(scene, views)
            losses = ex.fit(scene, views, SPCRT_STEPS, state)
            return scene, views, frame, state, losses

        t0 = time.perf_counter()
        (scene, views, frame, state, losses), launches = self.drive(
            list(self.counters()), path)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        self.check(all(n == 0 for n in launches.values()),
                   f"config 3 as written launched no kernel {launches}")
        pyr = scene["pyramid"].cpu().numpy()
        got = {"octree_bytes": len(scene["octree"]),
               "leaves": int(pyr[0, SPCRT_LEVEL]),
               "points": int(pyr[1, SPCRT_LEVEL + 1]),
               "dual_corners": scene["dual"].shape[0],
               "nuggets": len(frame["ridx"]),
               "rays_hit": int(torch.isfinite(frame["depth"]).sum())}
        full = rt._raytrace_frontier(scene["octree"], scene["exsum"],
                                     *views[0], SPCRT_LEVEL,
                                     4 * SPCRT_RES * SPCRT_RES)
        got["level_counts"] = full[5].tolist()
        self.check(not bool(full[6]), "view 0 fits the starting capacity "
                   f"{4 * SPCRT_RES * SPCRT_RES}")
        for k, want in SPCRT_EXPECT.items():
            self.check(got[k] == want, f"config 3 as written: {k} {got[k]} "
                       f"(JAX: {want})")
        depth = frame["depth"]
        hit = torch.isfinite(depth)
        others = [len(ex.trace(scene, v)[0]) for v in views[1:]]
        print(f"config 3 as written, L{SPCRT_LEVEL} {SPCRT_RES}²: view 0 hit "
              f"fraction {float(hit.float().mean()):.6f}, depth "
              f"[{float(depth[hit].min()):.6f}, {float(depth[hit].max()):.6f}]"
              f"; views 1-7 nuggets {others}", flush=True)
        first, last = losses[:10].mean(), losses[-10:].mean()
        self.check(bool(np.isfinite(losses).all())
                   and last < SPCRT_LOSS_RATIO * first,
                   f"nglod fit, {SPCRT_STEPS} steps: mean loss steps 41-50 "
                   f"{last:.6e} < {SPCRT_LOSS_RATIO} x steps 1-10 "
                   f"{first:.6e}")
        print("nglod fit loss: " + " ".join(f"{x:.6e}" for x in losses))
        # the loss over its view's target energy, mean(I*²): how far the
        # student's image is from the target, whatever the images' scale
        energy = torch.stack([(t ** 2).mean() for t in state["targets"]])
        rel = losses / energy.cpu().numpy()[np.arange(SPCRT_STEPS)
                                            % len(state["targets"])]
        print(f"nglod fit, relative image error mean|I - I*|² / mean|I*|²: "
              f"step 1 {rel[0]:.6e}, mean steps 1-10 {rel[:10].mean():.6e}, "
              f"steps 41-50 {rel[-10:].mean():.6e}; target energy "
              f"{float(energy.min()):.6e} to {float(energy.max()):.6e}",
              flush=True)
        print(f"config 3 as written, whole path (scene, 8 views, depth "
              f"render, targets, {SPCRT_STEPS} steps): {wall:.2f} s host "
              f"wall, peak {peak / 2 ** 20:.1f} MiB above "
              f"{base / 2 ** 20:.1f} MiB held [{self.card}]", flush=True)
        self.spcrt.update(scene=scene, views=views, state=state)

    def phase_spcrt_crosscheck(self):
        """Config 3's sphere shell (level 9, 512²) through the port's
        ``unbatched_raytrace``, first hits against kernel #4's depth map, as
        ``tests/render/test_spc_raster.py`` does in JAX: hit masks equal,
        depths within rtol 2e-6 / atol 1e-6, ids equal wherever the depth
        is bit for bit (at least 75% of the hits). #4-5 launch here,
        outside the counted path."""
        torch, ex = self.torch, self.spc_ex
        from kaolin_tpu_torch.render.camera import generate_rays
        rspc, cam, s = ex.build_scene(ex.config3_inputs(SPC_LEVEL), "cuda",
                                      SPC_RES)
        _, (t, nidx, valid, _) = ex.grow_caps(rspc, cam)
        o, d = generate_rays(cam)
        ridx, pidx, depth = self.rt.unbatched_raytrace(
            s["octree"], s["point_hierarchy"], s["pyramid"], s["exsum"], o,
            d, SPC_LEVEL)
        r = ridx.long()
        tin = depth[:, 0]
        best = torch.full((o.shape[0],), float("inf"), device="cuda")
        best = best.scatter_reduce(0, r, tin, "amin")
        tie = tin == best[r]
        best_id = torch.full((o.shape[0],), 2 ** 31 - 1, dtype=torch.int64,
                             device="cuda").scatter_reduce(
            0, r[tie], pidx[tie].long(), "amin")
        hit = torch.isfinite(best)
        same_mask = bool((valid == hit).all())
        close = same_mask and bool(torch.allclose(
            t[valid], best[valid], rtol=2e-6, atol=1e-6))
        exact = (t == best) & valid
        share = float(exact.sum()) / max(int(valid.sum()), 1)
        ids = bool((nidx[exact] == best_id[exact]).all())
        self.check(same_mask and close and share >= 0.75 and ids
                   and bool((nidx[~valid] == -1).all()),
                   f"cross-check at config 3 ({len(ridx)} nuggets): hit "
                   f"masks equal {same_mask} ({int(valid.sum())} hits), "
                   f"depths close {close}, {share:.4f} bit for bit, ids "
                   f"equal there {ids}")

    def phase_spcrt_timing(self):
        """Config 3 as written: ``unbatched_mesh_to_spc``, the dual and the
        trinkets (CUDA events, medians of 3), a depth frame and a fit step
        (CUDA events, median of 10; ``torch.profiler``: device busy, ops,
        idle share, the largest ops), and each one's peak memory."""
        torch, ex = self.torch, self.rt_ex
        sp = self.spcrt
        scene, views, state = sp["scene"], sp["views"], sp["state"]
        from kaolin_tpu_torch.ops.conversions import unbatched_mesh_to_spc
        from kaolin_tpu_torch.ops.spc import (unbatched_make_dual,
                                              unbatched_make_trinkets)
        fv = torch.from_numpy(ex.mesh_faces()).cuda()
        ph, pyr = scene["point_hierarchy"], scene["pyramid"]
        ms = {"mesh_to_spc": lambda: unbatched_mesh_to_spc(fv, SPCRT_LEVEL),
              "dual": lambda: unbatched_make_dual(ph, pyr),
              "trinkets": lambda: unbatched_make_trinkets(
                  ph, pyr, scene["dual"], scene["pyramid_dual"])}
        t = {k: statistics.median(self.time_ms(fn, 3))
             for k, fn in ms.items()}
        print(f"config 3 as written, set-up at L{SPCRT_LEVEL}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + f" [{self.card}]", flush=True)
        step = iter(range(SPCRT_STEPS, 10 ** 6))

        def fit_step():
            s = next(step) % ex.VIEWS
            return ex.fit_step(scene, state["student"], state["optimizer"],
                               views[s], state["targets"][s])
        paths = {"depth frame": lambda: ex.depth_render(scene, views[0]),
                 "fit step": fit_step}
        for label, fn in paths.items():
            event = statistics.median(self.time_ms(fn, SPCRT_TIMED))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            busy = self.profile_path(f"config 3 as written, {label} "
                                     f"({SPCRT_RES}²)", (), fn)
            t[label] = {"event_ms": event, "busy_ms": busy,
                        "peak_mib": peak / 2 ** 20}
            print(f"config 3 as written, {label} at {SPCRT_RES}²: "
                  f"{event:.4f} ms (CUDA events, median of {SPCRT_TIMED}), "
                  f"device busy {busy:.4f} ms, peak {peak / 2 ** 20:.1f} MiB "
                  f"above {base / 2 ** 20:.1f} MiB held [{self.card}]",
                  flush=True)
        sp["timing"] = t
        for key in ("scene", "views", "state"):   # 2.5 GB the card can use
            del sp[key]
        torch.cuda.empty_cache()

    # -- config 4: FlexiCubes, DMTet, the conversions and the metrics -----
    def flexi_inputs(self, res=FLEXI_PARITY_RES):
        """The card-vs-CPU inputs (numpy): the ellipsoid config 4 starts
        from and a seeded random field (its surface cubes include C16/C19
        cubes that invert), seeded weights and vertex features; a tet grid
        (the tutorial's at res 8) with two seeded fields; a noisy ball and
        a radial field as voxelgrids; two seeded point clouds (5,000
        points: three tiles of 2,048); jittered regular tets."""
        rng = np.random.RandomState(7)
        v, _ = self.FlexiCubes(device="cpu").construct_voxel_grid(res)
        v = v.numpy()
        n = res ** 3
        tet_v, tets = self.dmtet_ex.make_tet_grid(8)
        ijk = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1)
        r = np.linalg.norm(ijk - 4.5, axis=-1)
        rest = np.array([[0.0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                         [0.5, np.sqrt(3) / 6, np.sqrt(2 / 3)]])
        f32 = np.float32
        return {
            "fields": {
                "ellipsoid": (np.linalg.norm(v * [1.6, 0.7, 1.0], axis=-1)
                              - 0.35).astype(f32),
                "random": (rng.randn(v.shape[0]) * 0.1).astype(f32)},
            "beta": (rng.randn(n, 12) * 0.5).astype(f32),
            "alpha": (rng.randn(n, 8) * 0.5).astype(f32),
            "gamma_f": rng.randn(n).astype(f32),
            "features": rng.rand(v.shape[0], 4).astype(f32),
            "tet_v": np.stack([tet_v + rng.uniform(-0.05, 0.05, tet_v.shape)
                               for _ in range(2)]).astype(f32),
            "tets": tets,
            "tet_sdf": np.stack([np.linalg.norm(tet_v, axis=-1) - 0.6
                                 + 0.2 * rng.randn(tet_v.shape[0])
                                 for _ in range(2)]).astype(f32),
            "voxels": np.stack([(r + rng.randn(10, 10, 10)) < 3.5,
                                np.clip(1 - r / 4.5, 0, None)]).astype(f32),
            "p1": rng.randn(2, 1000, 3).astype(f32),
            "p2": rng.randn(2, 5000, 3).astype(f32),
            "tet_corners": ((rest + rng.uniform(-0.15, 0.15, (2, 50, 4, 3)))
                            * rng.uniform(0.5, 2.0, (2, 50, 1, 1))
                            ).astype(f32)}

    def flexi_outputs(self, inp, device, res=FLEXI_PARITY_RES):
        """Every config-4 module on ``device`` from ``inp`` → (integers,
        floats, gradients), dicts of tensors on the host: ``dense_extract``,
        ``__call__`` (split and training; with weights and features; the
        QEF placement; ``output_tetmesh``), ``jit_extract`` with its
        counts, the topology, the gradients in the field and the three
        weights; marching tets (both APIs), marching cubes, cube meshes,
        MISE, ``ops/voxelgrid`` and the three metrics modules."""
        torch, conv = self.torch, self.conv
        ints, floats, grads = {}, {}, {}

        def put(name, x):
            x = torch.as_tensor(x).detach().cpu()
            (floats if x.is_floating_point() else ints)[name] = x

        def on(a):
            return torch.from_numpy(np.array(a)).to(device)

        fc = self.FlexiCubes(device=device)
        v, c = fc.construct_voxel_grid(res)
        put("grid vertices", v)
        put("cube_idx", c)
        w = {k: on(inp[k]) for k in ("beta", "alpha", "gamma_f")}
        feats = on(inp["features"])
        for fname, f in inp["fields"].items():
            s = on(f)
            topo = fc.precompute_topology(s, c, res)
            tet = fc.precompute_tet_topology(s, c, topo)
            for k, x in (*topo._asdict().items(), *tet._asdict().items()):
                if x is not None:
                    put(f"{fname} topology {k}", x)
            for training in (False, True):
                tag = f"{fname} {'training' if training else 'split'}"
                dv, df, dl, aux = conv.dense_extract(s, res, training=training,
                                                     **w)
                for k, x in (("vertices", dv), ("faces", df), ("l_dev", dl),
                             ("face_mask", aux["face_mask"]),
                             ("vertex_mask", aux["vertex_mask"]),
                             *aux["counts"].items()):
                    put(f"{tag} dense {k}", x)
                for k, x in zip(("vertices", "faces", "l_dev", "features"),
                                fc(v, s, c, res, training=training,
                                   voxelgrid_features=feats, **w)):
                    put(f"{tag} __call__ {k}", x)
                for k, x in zip(("vertices", "tets", "l_dev"),
                                fc(v, s, c, res, training=training,
                                   output_tetmesh=True)):
                    put(f"{tag} tetmesh {k}", x)
                jv, jf, jl, jaux = fc.jit_extract(v, s, c, res,
                                                  training=training, **w)
                for k, x in (("vertices", jv), ("faces", jf), ("l_dev", jl),
                             ("face_mask", jaux["face_mask"]),
                             ("vertex_mask", jaux["vertex_mask"]),
                             *jaux["counts"].items()):
                    put(f"{tag} jit_extract {k}", x)
            names = ("sdf", "beta", "alpha", "gamma_f")
            for k, g in self.flexi_call_grads(inp, fname, device).items():
                grads[f"{fname} __call__ d/d{k}"] = g
            args = [s.clone().requires_grad_(True)] + [
                w[k].clone().requires_grad_(True) for k in names[1:3]]
            _, _, reg, aux = conv.dense_extract(
                args[0], res, training=True, **dict(zip(names[1:], args[1:])))
            vd, vm = aux["vd_dense"], aux["vd_valid_dense"]
            nv = vm.sum().clamp(min=1)
            ((torch.sqrt((vd * vd).sum(1)) - 0.35).abs() * vm).sum() \
                .div(nv).add(0.01 * reg.sum() / nv).backward()
            for k, a in zip(names, args):
                grads[f"{fname} dense d/d{k}"] = a.grad.cpu()
            sg = s.clone().requires_grad_(True)
            jv, jf, _, jaux = fc.jit_extract(v, sg, c, res, training=True)
            torch.where(jaux["face_mask"], (jv[jf].mean(1) ** 2).sum(-1),
                        0.0).sum().backward()
            grads[f"{fname} jit_extract d/dsdf"] = sg.grad.cpu()

        tv, tt, ts = on(inp["tet_v"]), on(inp["tets"]), on(inp["tet_sdf"])
        for b, out in enumerate(zip(*conv.marching_tetrahedra(tv, tt, ts,
                                                              True))):
            for k, x in zip(("vertices", "faces", "tet_idx"), out):
                put(f"marching_tetrahedra {b} {k}", x)
        for k, x in conv.marching_tetrahedra_fixed(tv[0], tt, ts[0]).items():
            put(f"marching_tetrahedra_fixed {k}", x)
        vox = on(inp["voxels"])
        for iso in (0.5, 0.2):
            for b, (mv, mf) in enumerate(zip(
                    *conv.voxelgrids_to_trianglemeshes(vox, iso))):
                put(f"marching cubes {iso} {b} vertices", mv)
                put(f"marching cubes {iso} {b} faces", mf)
        for tri in (True, False):
            for b, (mv, mf) in enumerate(zip(
                    *conv.voxelgrids_to_cubic_meshes(vox > 0.5, tri))):
                put(f"cubic meshes {tri} {b} vertices", mv)
                put(f"cubic meshes {tri} {b} faces", mf)
        put("MISE", conv.sdf_to_voxelgrids(
            [lambda p: (p ** 2).sum(1) ** 0.5 - 0.4,
             lambda p: torch.sqrt(((p - torch.tensor(
                 [0.05, 0.0, -0.1], device=p.device)) ** 2).sum(1)) - 0.3],
            init_res=8, upsampling_steps=2, device=device))
        vgo = self.vgops
        binary = vox[:1] > 0.5
        put("downsample", vgo.downsample(vox, [2, 2, 5]))
        for mode in ("wide", "thin"):
            put(f"extract_surface {mode}", vgo.extract_surface(binary, mode))
        put("fill", vgo.fill(vox > 0.3))
        odms = vgo.extract_odms(vox > 0.3)
        put("extract_odms", odms)
        put("project_odms", vgo.project_odms(odms, votes=2))
        put("iou", self.metrics.voxelgrid.iou(binary, vox[1:] > 0.3))
        pcm, tm = self.metrics.pointcloud, self.metrics.tetmesh
        p1, p2 = on(inp["p1"]), on(inp["p2"])
        for k, x in zip(("dist", "idx"), pcm.sided_distance(p1, p2)):
            put(f"sided_distance {k}", x)
        put("chamfer_distance", pcm.chamfer_distance(p1, p2[:, :1500]))
        put("f_score", pcm.f_score(p1, p2[:, :1500], 0.1))
        a = p1.clone().requires_grad_(True)
        b = p2[:, :1500].clone().requires_grad_(True)
        pcm.chamfer_distance(a, b).sum().backward()
        grads["chamfer d/dp1"], grads["chamfer d/dp2"] = a.grad.cpu(), \
            b.grad.cpu()
        corners = on(inp["tet_corners"])
        put("tetrahedron_volume", tm.tetrahedron_volume(corners))
        put("equivolume", tm.equivolume(corners))
        put("amips", tm.amips(corners, torch.eye(3, device=device)))
        return ints, floats, grads

    def flexi_call_grads(self, inp, fname, device, dtype=None,
                         res=FLEXI_PARITY_RES):
        """d(sum v² + sum l_dev)/d(sdf, beta, alpha, gamma_f) through
        ``FlexiCubes.__call__`` (training split, fixed topology) on
        ``device``, in ``dtype`` (float32 unless named) → {name: gradient
        on the host}."""
        torch = self.torch
        names = ("sdf", "beta", "alpha", "gamma_f")
        fc = self.FlexiCubes(device=device)
        v, c = fc.construct_voxel_grid(res)
        dtype = dtype or v.dtype
        args = [torch.from_numpy(np.array(x)).to(device, dtype)
                .requires_grad_(True)
                for x in (inp["fields"][fname], *(inp[k] for k in names[1:]))]
        topo = fc.precompute_topology(args[0], c, res)
        vv, _, ll = fc(v.to(dtype), args[0], c, res, topology=topo,
                       training=True, **dict(zip(names[1:], args[1:])))
        ((vv ** 2).sum() + ll.sum()).backward()
        return {k: a.grad.cpu() for k, a in zip(names, args)}

    def qef_case(self, inp, device, res=FLEXI_PARITY_RES):
        """The QEF placement of the ellipsoid with its own normal, split
        and training, on ``device`` → {mode: (vertices, faces, normals' split
        from the vertices)} on the host and the topology (host)."""
        torch = self.torch
        k2 = torch.tensor([1.6, 0.7, 1.0], device=device) ** 2

        def normal(x):
            return x * k2 / torch.linalg.norm(x * k2, dim=-1, keepdim=True)

        fc = self.FlexiCubes(device=device)
        v, c = fc.construct_voxel_grid(res)
        s = torch.from_numpy(inp["fields"]["ellipsoid"]).to(device)
        topo = fc.precompute_topology(s, c, res)
        nvd, q = topo.total_num_vd, topo.quad_vd_idx
        out = {}
        for training in (False, True):
            vv, ff, _ = fc(v, s, c, res, grad_func=normal, training=training)
            n = normal(vv[:nvd])
            n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(
                min=1e-12)
            g02 = (n[q[:, 0]] * n[q[:, 2]]).sum(-1)
            g13 = (n[q[:, 1]] * n[q[:, 3]]).sum(-1)
            if training:
                rule = q[:, [0, 1, 1, 2, 2, 3, 3, 0]]
                got = ff.reshape(-1, 4, 3)[:, :, :2].reshape(-1, 8)
            else:
                rule = torch.where((g02 > g13)[:, None],
                                   q[:, [0, 1, 2, 0, 2, 3]],
                                   q[:, [0, 1, 3, 3, 1, 2]]).reshape(-1, 3)
                got = ff
            out["training" if training else "split"] = (
                vv[:nvd].cpu(), bool(torch.equal(got, rule)))
        return out, {k: (x.cpu().numpy() if torch.is_tensor(x) else x)
                     for k, x in topo._asdict().items()}, c.cpu().numpy()

    def qef_reference(self, topo, cube_idx, field, res=FLEXI_PARITY_RES,
                      reg=1e-3):
        """Each dual vertex's QEF solution in float64 numpy, one
        ``np.linalg.lstsq`` a vertex, from the host topology: the system
        ``FlexiCubes._solve_qef`` builds."""
        v, _ = self.FlexiCubes(device="cpu").construct_voxel_grid(res)
        v = v.numpy().astype(np.float64)
        k2 = np.array([1.6, 0.7, 1.0]) ** 2
        e = topo["surf_edges"]
        s0 = field[e[:, 0]].astype(np.float64)
        s1 = field[e[:, 1]].astype(np.float64)
        zc = (v[e[:, 0]] * s1[:, None] - v[e[:, 1]] * s0[:, None]) \
            / (s1 - s0)[:, None]
        nrm = zc * k2 / np.linalg.norm(zc * k2, axis=-1, keepdims=True)
        idx = topo["idx_map"].reshape(-1)[topo["edge_group_to_cube"] * 12
                                          + topo["edge_group"]]
        surf_rows = cube_idx[topo["surf_cubes"]]
        out = np.zeros((topo["total_num_vd"], 3))
        for vd in range(topo["total_num_vd"]):
            sel = topo["edge_group_to_vd"] == vd
            p, n = zc[idx[sel]], nrm[idx[sel]]
            v0 = v[surf_rows[topo["edge_group_to_cube"][sel][0], 0]]
            a = np.concatenate([n, np.eye(3) * reg])
            b = np.concatenate([((p - v0) * n).sum(-1),
                                reg * (p.mean(0) - v0)])
            out[vd] = np.linalg.lstsq(a, b, rcond=None)[0] + v0
        return out

    def check_qef(self, inp):
        """The QEF placement on each device against the float64 solve of
        the same systems: float32 QR solves (``gels``) of systems that the
        1e-3 regularization rows leave ill-conditioned sit near 1e-5 from
        it, so the card is held within 1e-5 or twice the CPU's distance,
        whichever is larger, the CPU within 1e-5 (as the CPU test holds
        it); each device's faces follow the split rule on its own
        vertices."""
        cases = {d: self.qef_case(inp, d) for d in ("cpu", "cuda")}
        topo, cube_idx = cases["cpu"][1], cases["cpu"][2]
        want = self.qef_reference(topo, cube_idx,
                                  inp["fields"]["ellipsoid"])
        bound = FLEXI_TOL["qef"]
        for d, (out, _, _) in cases.items():
            errs = {m: float(np.abs(vv.double().numpy() - want).max())
                    for m, (vv, _) in out.items()}
            for mode, (vv, rule_ok) in out.items():
                self.check(errs[mode] <= bound and rule_ok,
                           f"flexi QEF ({mode}) on {d}: {len(want)} dual "
                           f"vertices within {errs[mode]:.3g} of the float64 "
                           f"solve (bound {bound:.3g}), faces follow the "
                           f"split rule {rule_ok}")
            if d == "cpu":
                bound = max(bound, FLEXI_TOL["own"] * max(errs.values()))
        gap = max(float((cases["cuda"][0][m][0] - cases["cpu"][0][m][0])
                        .abs().max()) for m in ("split", "training"))
        print(f"  QEF vertices card vs CPU: {gap:.3g}")

    def phase_flexi_parity(self):
        """Config 4's modules on the card against the port on the CPU from
        the same inputs (``flexi_inputs``, res 16): the grid, every topology
        array, faces, tets, masks, counts and the other integers equal; the
        floats within 1e-6 (of max(1, max|x|)); the gradients in the field,
        beta, alpha and gamma_f (and the chamfer's in its points) within
        1e-5 of max|g|."""
        torch = self.torch
        inp = self.flexi_inputs()
        card = self.flexi_outputs(inp, "cuda")
        cpu = self.flexi_outputs(inp, "cpu")
        for i, kind in enumerate(("integer", "float", "gradient")):
            self.check(card[i].keys() == cpu[i].keys(),
                       f"flexi parity: the same {kind} outputs on both "
                       "devices")
        ints, floats, grads = cpu
        # gamma_f's gradient is a difference of nearby dual vertices (the
        # quad centre's pull): float32 holds it to its own distance from
        # float64, which the two devices may each take
        own = {}
        for fname in inp["fields"]:
            exact = {d: self.flexi_call_grads(inp, fname, d,
                                              self.torch.float64)
                     for d in ("cuda", "cpu")}
            f64 = max(self.grad_err(exact["cuda"][k], exact["cpu"][k])
                      for k in exact["cpu"])
            self.check(f64 <= FLEXI_TOL["f64"],
                       f"flexi parity: {fname} __call__ gradients in float64 "
                       f"card vs CPU {f64:.3g} (bound {FLEXI_TOL['f64']:g})")
            own[fname] = self.grad_err(grads[f"{fname} __call__ d/dgamma_f"],
                                       exact["cpu"]["gamma_f"])
            print(f"  {fname}: the CPU's float32 gradient in gamma_f against "
                  f"float64 {own[fname]:.3g} of max|g|")
        self.check_qef(inp)
        bad_ints = [k for k in ints if not torch.equal(card[0][k], ints[k])]
        self.check(not bad_ints, f"flexi parity: {len(ints)} integer "
                   f"arrays card = CPU (differ: {bad_ints})")
        ferr = {k: self.rel_err(card[1][k], x) for k, x in floats.items()}
        gerr = {k: self.grad_err(card[2][k], x) for k, x in grads.items()}
        bound = {k: FLEXI_TOL["grad"] for k in gerr}
        for fname, e in own.items():
            k = f"{fname} __call__ d/dgamma_f"
            bound[k] = max(FLEXI_TOL["grad"], FLEXI_TOL["own"] * e)
        for label, errs, tol in (("float", ferr, {}),
                                 ("gradient", gerr, bound)):
            worst = sorted(errs.items(), key=lambda kv: -kv[1])
            over = [f"{k} {e:.3g}" for k, e in worst
                    if e > tol.get(k, FLEXI_TOL["float"])]
            self.check(not over, f"flexi parity: {len(errs)} {label} "
                       f"arrays card vs CPU within their bounds (over: "
                       f"{over})")
            print(f"  largest {label} errors: " + ", ".join(
                f"{k} {e:.3g}" for k, e in worst[:6]))
        counts = {k: int(x) for k, x in ints.items()
                  if x.dim() == 0 and k.endswith(("surf_cubes", "quads"))}
        print("  counts: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
        self.flexi["parity"] = {"float": max(ferr.values()),
                                "grad": max(gerr.values())}

    def flexi_step_on(self, form, field, device):
        """One step of ``form`` from ``field`` (numpy) on ``device`` →
        (integers, loss, gradient) on the host."""
        fx = self.flexi_ex
        state = fx.setup(FLEXI_RES, device, sdf=self.torch.from_numpy(field))
        if form == "bench":
            loss, aux = fx.bench_loss(state["sdf"], FLEXI_RES)
            ints = {k: int(x) for k, x in aux["counts"].items()}
        else:
            topo = state["fc"].precompute_topology(
                state["sdf"], state["cube_idx"], FLEXI_RES)
            loss, _, faces = fx.topology_loss(state, topo)
            ints = {k: x.cpu() for k, x in topo._asdict().items()
                    if self.torch.is_tensor(x)}
            ints["faces"] = faces.cpu()
        loss.backward()
        return ints, float(loss.detach()), state["sdf"].grad.cpu()

    def phase_flexi_path(self):
        """Config 4 at full width on the card, every launch counter set to
        0 just before and read just after: both forms of
        ``examples/torch_flexicubes_sdf.py`` at res 64 for 50 steps (step 1
        gives the JAX package's 9,240 surface cubes, 9,238 quads, 36,952
        training faces and 1,810,624 / 3,048,192 dense slots; every loss
        finite, step 50's below step 1's) and
        ``examples/torch_tutorial_dmtet.py`` in full (res 24, 120 steps,
        2,048 targets; it raises unless the chamfer halves). No kernel may
        launch. Then one step of each form card vs CPU from the start field
        (integers equal, loss within 1e-5 relative, gradient within 1e-5 of
        max|g|; at the fitted field vertices sit on the target sphere, where
        the loss's |·| flips its gradient with the last bit: ``flexi_kink``
        counts them) and marching cubes of the fitted field card = CPU."""
        torch, fx, dm = self.torch, self.flexi_ex, self.dmtet_ex
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def path():
            out = {}
            for form in ("bench", "topology"):
                state = fx.setup(FLEXI_RES, "cuda")
                if form == "bench":
                    with torch.no_grad():
                        v, f, _, _ = fx.dense_extract(state["sdf"], FLEXI_RES,
                                                      training=True)
                    loss, counts = fx.bench_step(state)
                    got = {k: int(x) for k, x in counts.items()}
                    got.update(vertex_slots=v.shape[0], face_slots=f.shape[0],
                               faces=4 * got["quads"])
                else:
                    topo = state["fc"].precompute_topology(
                        state["sdf"], state["cube_idx"], FLEXI_RES)
                    with torch.no_grad():
                        faces = fx.topology_loss(state, topo)[2]
                    loss, topo = fx.topology_step(state)
                    got = {"surf_cubes": int(topo.surf_cubes.sum()),
                           "dual_vertices": topo.total_num_vd,
                           "quads": topo.quad_vd_idx.shape[0],
                           "faces": faces.shape[0]}
                losses = torch.cat([loss[None],
                                    fx.run(form, state, FLEXI_STEPS - 1)])
                out[form] = (state, got, losses.cpu().numpy())
            out["dmtet"] = dm.main("cuda")
            return out

        t0 = time.perf_counter()
        out, launches = self.drive(list(self.counters()), path)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        self.check(all(n == 0 for n in launches.values()),
                   f"config 4 (both forms, DMTet) launched no kernel "
                   f"{launches}")
        for form in ("bench", "topology"):
            state, got, losses = out[form]
            for k, want in FLEXI_EXPECT.items():
                if k in got:
                    self.check(got[k] == want, f"config 4 {form} form step "
                               f"1: {k} {got[k]} (JAX: {want})")
            self.check(bool(np.isfinite(losses).all())
                       and losses[-1] < losses[0],
                       f"config 4 {form} form, {FLEXI_STEPS} steps at res "
                       f"{FLEXI_RES}: finite, loss {losses[0]:.6f} → "
                       f"{losses[-1]:.6f}")
            print(f"config 4 {form} form loss: " + " ".join(
                f"{x:.6f}" for x in losses))
        d = out["dmtet"]
        self.check(bool(np.isfinite(d["losses"]).all())
                   and d["last"] < 0.5 * d["first"],
                   f"DMTet {len(d['losses'])} steps at res {dm.RES}: chamfer "
                   f"{d['first']:.5f} → {d['last']:.5f}, {d['verts']} "
                   f"vertices, {d['faces']} faces")
        print(f"config 4 and DMTet, whole path (2 x {FLEXI_STEPS} steps at "
              f"res {FLEXI_RES}, DMTet's {len(d['losses'])}): {wall:.2f} s "
              f"host wall, peak {peak / 2 ** 20:.1f} MiB above "
              f"{base / 2 ** 20:.1f} MiB held [{self.card}]", flush=True)
        start = fx.setup(FLEXI_RES, "cuda")["sdf"].detach().cpu().numpy()
        for form in ("bench", "topology"):
            (ic, lc, gc), (ih, lh, gh) = (self.flexi_step_on(form, start, d)
                                         for d in ("cuda", "cpu"))
            same = ic.keys() == ih.keys() and all(
                torch.equal(torch.as_tensor(ic[k]).cpu(),
                            torch.as_tensor(ih[k])) for k in ih)
            l_err = abs(lc - lh) / abs(lh)
            g_err = self.grad_err(gc, gh)
            self.check(same and l_err <= FLEXI_TOL["loss"]
                       and g_err <= FLEXI_TOL["grad"],
                       f"config 4 {form} step card vs CPU from the start "
                       f"field: integers equal {same}, loss {l_err:.3g} "
                       f"relative, gradient {g_err:.3g} of max|g|")
        self.flexi_kink(out["topology"][0])
        state = out["topology"][0]
        mc_card = fx.marching_cubes(state)
        cpu_state = {"sdf": state["sdf"].detach().cpu(), "res": FLEXI_RES}
        mc_cpu = fx.marching_cubes(cpu_state)
        self.check(all(torch.equal(a.cpu(), b)
                       for a, b in zip(mc_card, mc_cpu)),
                   f"marching cubes of the fitted field at res {FLEXI_RES} "
                   f"card = CPU ({mc_cpu[0].shape[0]} vertices, "
                   f"{mc_cpu[1].shape[0]} faces)")
        self.flexi.update(path_wall=wall, path_peak=peak, dmtet=d)

    def flexi_kink(self, state):
        """At the fitted field the topology form's vertices sit on the
        target sphere, where |‖v‖ − 0.35|'s gradient flips sign with the
        last bit: how many vertices take the other sign on the CPU than on
        the card, and the gradient gap with and without them."""
        torch, fx = self.torch, self.flexi_ex
        field = state["sdf"].detach().cpu().numpy()
        sides = {}
        for d in ("cuda", "cpu"):
            st = fx.setup(FLEXI_RES, d, sdf=torch.from_numpy(field))
            topo = st["fc"].precompute_topology(st["sdf"], st["cube_idx"],
                                                FLEXI_RES)
            loss, verts, _ = fx.topology_loss(st, topo)
            loss.backward()
            sides[d] = (torch.linalg.norm(verts.detach(), dim=-1).cpu()
                        - fx.TARGET_R, st["sdf"].grad.cpu())
        (dc, gc), (dh, gh) = sides["cuda"], sides["cpu"]
        flips = int((torch.sign(dc) != torch.sign(dh)).sum())
        near = int((dh.abs() < 1e-6).sum())
        print(f"  fitted field, topology form: {flips} of {dh.shape[0]} "
              f"vertices on the other side of radius {fx.TARGET_R} on the "
              f"card ({near} within 1e-6 of it); gradient card vs CPU "
              f"{self.grad_err(gc, gh):.3g} of max|g|")

    def phase_flexi_timing(self):
        """Config 4 and DMTet on the card: the bench form's step (forward,
        backward, Adam) and its 50-step run, the topology form's step and
        its topology alone, the DMTet step; CUDA events, medians of 10 (the
        50-step run: of 3) after a warm-up; each one's peak memory. The
        states stay for ``phase_profile``."""
        torch, fx, dm = self.torch, self.flexi_ex, self.dmtet_ex
        bench = fx.setup(FLEXI_RES, "cuda")
        topo = fx.setup(FLEXI_RES, "cuda")
        dmt = dm.setup("cuda")
        steps = {"bench step": lambda: fx.bench_step(bench),
                 "topology step": lambda: fx.topology_step(topo),
                 "topology alone": lambda: topo["fc"].precompute_topology(
                     topo["sdf"], topo["cube_idx"], FLEXI_RES),
                 "DMTet step": lambda: dm.step(dmt)}
        t = {}
        for label, fn in steps.items():
            event = statistics.median(self.time_ms(fn, FLEXI_TIMED))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            t[label] = {"event_ms": event, "peak_mib": peak / 2 ** 20}
            print(f"config 4, {label}: {event:.4f} ms (CUDA events, median "
                  f"of {FLEXI_TIMED}), peak {peak / 2 ** 20:.1f} MiB above "
                  f"{base / 2 ** 20:.1f} MiB held [{self.card}]", flush=True)
        run = statistics.median(self.time_ms(
            lambda: fx.run("bench", bench, FLEXI_STEPS), 3))
        t["bench run"] = {"event_ms": run}
        share = (t["topology alone"]["event_ms"]
                 / t["topology step"]["event_ms"])
        print(f"config 4 bench form, {FLEXI_STEPS} steps: {run:.4f} ms "
              f"({run / FLEXI_STEPS:.4f} ms a step; CUDA events, median of "
              f"3); the topology's share of a topology step {share:.3f} "
              f"[{self.card}]", flush=True)
        self.flexi.update(timing=t, states=(bench, topo, dmt))

    def profile_flexi(self):
        """Config 4's two steps and the DMTet step under the profiler:
        device ops a step, busy, idle share and the largest ops."""
        fx, dm = self.flexi_ex, self.dmtet_ex
        bench, topo, dmt = self.flexi.pop("states")
        busy = {
            "bench": self.profile_path(
                f"config 4 bench step (res {FLEXI_RES})", (),
                lambda: fx.bench_step(bench)),
            "topology": self.profile_path(
                f"config 4 topology step (res {FLEXI_RES})", (),
                lambda: fx.topology_step(topo)),
            "dmtet": self.profile_path(f"DMTet step (res {dm.RES})", (),
                                       lambda: dm.step(dmt))}
        self.flexi["busy"] = busy
        self.torch.cuda.empty_cache()

    # -- config 5: the simulatable-3DGS scene -------------------------------
    def gauss_shells(self):
        """The CPU tests' small shell (300 gaussians of scale 0.04) and the
        bench's (2,000 of scale 0.05), numpy (xyz, scales, rots, opac)."""
        ex = self.gauss_ex
        return {"small": ex.shell_gaussians(300, 0.04)[0],
                "bench": ex.shell_gaussians(2000, 0.05)[0]}

    def gauss_normalized(self, shell):
        """The densifier's normalization of a shell into [-1, 1] (float64)
        → (xyz, scales, rots, opacities, center, dmax)."""
        xyz, scales, rots, opac = (np.asarray(a, np.float64) for a in shell)
        lo, hi = xyz.min(0), xyz.max(0)
        dmax = 0.5 * (hi - lo).max() + 0.05
        center = 0.5 * (lo + hi)
        return (xyz - center) / dmax, scales / dmax, rots, opac, center, dmax

    @contextlib.contextmanager
    def gauss_frames(self, res=None):
        """Carving from the CPU's frames: ``RayTracedSPCDataset`` made on
        the host (at views of 2^res pixels, the default 2^8 when None) and
        each tensor moved to the octree's device, so that the card's and
        the CPU's carving read one set of depth maps (the raytrace's own
        card vs CPU check is phase_spcrt_parity's)."""
        import kaolin_tpu_torch.ops.spc as spc
        orig = spc.RayTracedSPCDataset

        def frames(viewpoints, gs_octree, res_=8):
            ds = orig(viewpoints, gs_octree.cpu(),
                      res=res_ if res is None else res)
            dev = gs_octree.device
            return [tuple(x.to(dev) if isinstance(x, self.torch.Tensor)
                          else x for x in ds[i]) for i in range(len(ds))]

        spc.RayTracedSPCDataset = frames
        try:
            yield
        finally:
            spc.RayTracedSPCDataset = orig

    @contextlib.contextmanager
    def densifier_warnings(self):
        """The densifier's log records at WARNING and above (its carve →
        flood-fill fallback), while inside."""
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        log = logging.getLogger("kaolin_tpu_torch.ops.gaussians.densifier")
        log.addHandler(handler)
        try:
            yield records
        finally:
            log.removeHandler(handler)

    def bf_fixture(self, device):
        """tests/ops/test_bf_recon.py's sphere shell at level 6 (six views
        at 128², sigma 0.05) carved from the CPU's frames on ``device`` →
        bf_recon's (octree, empty, colors, normals)."""
        torch = self.torch
        from kaolin_tpu_torch.ops import spc
        level, res = 6, 64
        g = (np.arange(res) + 0.5) / res * 2.0 - 1.0
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        r = np.sqrt(x * x + y * y + z * z)
        pts = np.stack(np.nonzero(np.abs(r - 0.6) < (2.5 / res)),
                       axis=-1).astype(np.int16)
        octree = spc.unbatched_points_to_octree(torch.from_numpy(pts), level)
        ds = spc.RayTracedSPCDataset(GAUSS_BF_VIEWS, octree, res=7)
        frames = [tuple(x.to(device) if isinstance(x, torch.Tensor) else x
                        for x in ds[i]) for i in range(len(ds))]
        return spc.bf_recon(frames, level, 0.05)

    def gauss_step_errs(self, card, cpu, n):
        """The card's step from the CPU scene's states over ``n`` CPU steps
        → max |d(B z)| / max|B z| per step (crossing the QR basis in
        float64 where the pivots differ, as phase_sim_parity does)."""
        torch, f64 = self.torch, self.torch.float64
        states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
        for _ in range(n):
            cpu.run_sim_step()
            states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
        oc, og = cpu.get_object(0), card.get_object(0)
        same = torch.equal(og.qr_tfm.cpu(), oc.qr_tfm)
        conv = og.qr_tfm_inv.cpu().to(f64) @ oc.qr_tfm.to(f64)
        fn, consts = card.build_functional_step(with_diag=True)
        errs, flags = [], []
        for k in range(n):
            z_in = [(x if same else (conv @ x.to(f64)).float()).cuda()
                    for x in states[k]]
            with torch.no_grad():
                out = fn(consts, *z_in)
            got = card.sim_B.cpu().to(f64) @ out[0].cpu().to(f64)
            want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
            errs.append(float((got - want).abs().max() / want.abs().max()))
            flags.append(int(out[3]))
        return errs, flags, same

    def phase_gauss_parity(self):
        """Config 5's modules on the card against the port's CPU: the
        transforms (2,000 gaussians, SH degree 3) within 1e-6 of max|x|;
        ``gs_to_voxelgrid`` coords equal and opacities within 1e-9
        relative (the small shell at level 6, the bench's at 5);
        ``bf_recon`` on tests/ops/test_bf_recon.py's fixture, bytes and
        colors equal; the densifier with ``jitter=False`` by flood fill and
        by carving (the CPU tests' eight views at 64², from one set of
        frames), points within 1e-6; the bench scene's step from the CPU's
        states, B z within 1e-4 of max|B z|."""
        torch, ex = self.torch, self.gauss_ex
        from kaolin_tpu_torch.ops.conversions import gs_to_voxelgrid
        from kaolin_tpu_torch.ops.gaussians import (
            sample_points_in_volume,
            transform_gaussians,
        )
        self.check_precision("phase_gauss_parity")
        rng = np.random.RandomState(0)
        n = 2000
        q = rng.randn(n, 4)
        arrays = [rng.randn(n, 3), q / np.linalg.norm(q, axis=1)[:, None],
                  rng.rand(n, 3) + 0.1]
        sh = rng.randn(n, 16, 3).astype(np.float32)
        c, s = np.cos(0.9), np.sin(0.9)
        t = np.array([[1.5 * c, -1.5 * s, 0, 0.3], [1.5 * s, 1.5 * c, 0, -0.2],
                      [0, 0, 1.5, 0.1], [0, 0, 0, 1]], np.float32)
        outs = {}
        for dev in ("cpu", "cuda"):
            args = [torch.from_numpy(a.astype(np.float32)).to(dev)
                    for a in arrays]
            outs[dev] = transform_gaussians(
                *args, torch.from_numpy(t).to(dev),
                sh_coeff=torch.from_numpy(sh).to(dev))
        errs = [float((g.cpu() - h).abs().max() / h.abs().max())
                for g, h in zip(outs["cuda"], outs["cpu"])]
        self.check(max(errs) <= GAUSS_TOL["transform"],
                   f"transform_gaussians card vs CPU ({n} gaussians, SH "
                   f"degree 3, rotation, scale 1.5 and translation): max "
                   f"|d| / max|x| positions {errs[0]:.2e}, orientations "
                   f"{errs[1]:.2e}, scales {errs[2]:.2e}, SH {errs[3]:.2e}")

        shells = self.gauss_shells()
        for label, level in (("small", 6), ("bench", 5)):
            nrm = self.gauss_normalized(shells[label])[:4]
            got = {dev: gs_to_voxelgrid(*nrm, level=level, device=dev)
                   for dev in ("cpu", "cuda")}
            same = torch.equal(got["cuda"][0].cpu(), got["cpu"][0])
            rel = float(((got["cuda"][1].cpu() - got["cpu"][1]).abs()
                         / got["cpu"][1].abs()).max()) if same \
                else float("inf")
            self.check(same and rel <= GAUSS_TOL["opacity"],
                       f"gs_to_voxelgrid card vs CPU, the {label} shell at "
                       f"level {level}: {got['cpu'][0].shape[0]} voxels, "
                       f"coords equal {same}, opacities within {rel:.2e} "
                       f"relative")

        rec = {dev: self.bf_fixture(dev) for dev in ("cpu", "cuda")}
        eq = [torch.equal(a.cpu(), b) for a, b in zip(rec["cuda"][:3],
                                                      rec["cpu"][:3])]
        na, nb = rec["cuda"][3].cpu(), rec["cpu"][3]
        fin = torch.isfinite(nb)
        # a missed ray's depth step (inf − inf) leaves NaN and inf normals
        n_err = float((na - nb)[fin].abs().max()) if torch.equal(
            torch.isfinite(na), fin) and torch.equal(
                na[~fin].nan_to_num(0.0), nb[~fin].nan_to_num(0.0)) \
            else float("inf")
        self.check(all(eq) and n_err <= GAUSS_TOL["points"],
                   f"bf_recon card vs CPU at level 6 (six views at 128², "
                   f"{rec['cpu'][0].shape[0]} octree bytes): octree, empty, "
                   f"colors equal {eq}; normals within {n_err:.2e} where "
                   f"finite, NaN and inf where the CPU's are")

        kw = dict(octree_level=6, jitter=False, num_samples=None,
                  viewpoints=GAUSS_CARVE_VIEWS)
        for method in ("floodfill", "carve"):
            with self.gauss_frames(6), self.densifier_warnings() as warned:
                got = {dev: sample_points_in_volume(
                    *shells["small"], method=method, device=dev, **kw)
                    for dev in ("cpu", "cuda")}
            same_shape = got["cuda"].shape == got["cpu"].shape
            err = float((got["cuda"].cpu() - got["cpu"]).abs().max()) \
                if same_shape else float("inf")
            self.check(same_shape and err <= GAUSS_TOL["points"]
                       and not warned,
                       f"densifier card vs CPU, {method}, the small shell "
                       f"at level 6: {got['cpu'].shape[0]} points, max |d| "
                       f"{err:.2e}, {len(warned)} fallback warnings")

        card, _, _, vol = ex.bench_scene("cuda")
        cpu, *_ = ex.build(ex.BENCH, "cpu", vol_pts=vol.cpu())
        errs, flags, same = self.gauss_step_errs(card, cpu,
                                                 GAUSS_PARITY_STEPS)
        self.check(max(errs) <= GAUSS_TOL["z"] and not any(flags),
                   f"config-5 bench scene step card vs CPU [D "
                   f"{card.total_dofs}, {card.total_qp} points, broad phase "
                   f"{card.force_dict['collision']['object'].broad_phase}],"
                   f" {GAUSS_PARITY_STEPS} steps from the CPU's states: max "
                   f"|d(B z)| / max|B z| {max(errs):.3e} (per step "
                   + ", ".join(f"{e:.1e}" for e in errs)
                   + f"), flags {flags}, the same QR pivots {same} "
                   f"[{self.card}]")

    def phase_gauss_path(self):
        """Config 5 in full (bench.py's bench_gaussians_sim): the 2,000
        gaussians densified at level 6 by flood fill into 2,048 points, the
        scene, then 100 steps LBS-moving the renderable gaussians each step,
        eager and from the CUDA graph from one start, every launch counter
        set to 0 before each and read after. Then one step of the same
        scene with the grid broad phase forced, against the auto choice;
        and the densifier at its defaults (level 8, carving from the 86
        default views at 256²) on the same gaussians, set-up once."""
        torch, ex = self.torch, self.gauss_ex
        from kaolin_tpu_torch.ops.gaussians import sample_points_in_volume
        self.check_precision("phase_gauss_path")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scene, idx, xyz, vol = ex.bench_scene("cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        col = scene.force_dict["collision"]["object"]
        grid_tests = (col.max_occupied_cells * 14 * col.cell_capacity ** 2
                      if col.max_occupied_cells else None)
        print(f"config 5: {vol.shape[0]} interior points, {xyz.shape[0]} "
              f"renderable gaussians, D {scene.total_dofs}, broad phase "
              f"{col.broad_phase} (the grid's M·14·K² = {grid_tests} tests "
              f"against N² = {scene.total_qp ** 2}), {col.max_contacts} "
              f"contacts; set-up {build_s:.3f} s host (densifier, bake, "
              f"QR) [{self.card}]", flush=True)
        start = [x.clone() for x in (scene.sim_z, scene.sim_z_prev,
                                     scene.sim_z_dot)]
        steps = ex.BENCH["steps"]
        runs = {}
        for label, graphs in (("eager", False), ("graph", True)):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs
            resizes = scene.collision_resizes

            def path():
                moved = ex.rollout(scene, idx, steps)
                return moved, scene.check_collision_capacity()

            t0 = time.perf_counter()
            (moved, flags), launches = self.drive(tuple(KERNELS), path)
            wall = time.perf_counter() - t0
            heights = moved[:, :, 1].mean(dim=1).cpu()
            runs[label] = dict(
                z=scene.sim_z.clone(), flags=flags, heights=heights,
                low=float(moved[:, :, 1].min()), launches=launches,
                resizes=scene.collision_resizes - resizes,
                finite=bool(torch.isfinite(moved).all()) and all(
                    bool(torch.isfinite(x).all())
                    for x in (scene.sim_z, scene.sim_z_dot)),
                state=[x.clone() for x in (scene.sim_z, scene.sim_z_prev,
                                           scene.sim_z_dot)])
            print(f"config 5, {steps} steps {label}: {wall:.3f} s host wall"
                  f" (the graph's capture included), flags {flags}, "
                  f"{runs[label]['resizes']} resizes, renderable mean "
                  f"heights every 20 steps "
                  + ", ".join(f"{float(h):.4f}" for h in heights[::20])
                  + f", last {float(heights[-1]):.4f}, lowest renderable "
                  f"point {runs[label]['low']:.4f}, "
                  f"{scene.graph_steps_rerun} graph steps run again eagerly,"
                  f" {scene.graph_steps_lu} took the LU, kernel launches "
                  f"{launches} [{self.card}]", flush=True)
        peak = torch.cuda.max_memory_allocated()
        za, zb = runs["eager"]["z"], runs["graph"]["z"]
        z_err = float((za - zb).abs().max() / za.abs().max())
        B = scene.sim_B.to(torch.float64)
        be, bg = B @ za.to(torch.float64), B @ zb.to(torch.float64)
        bz_err = float((be - bg).abs().max() / be.abs().max())
        auto = ("grid" if scene.total_qp >= scene.GRID_BROAD_PHASE_THRESHOLD
                and (grid_tests is None or scene.total_qp ** 2 >= grid_tests)
                else "dense")
        self.check(all(r["finite"] and r["flags"] == 0 and r["resizes"] == 0
                       and not any(r["launches"].values())
                       and float(r["heights"][-1])
                       < float(r["heights"][0]) - 0.1
                       and float(r["heights"].min()) > 0.0
                       for r in runs.values())
                   and scene.graph_steps_rerun == 0
                   and z_err <= GAUSS_TOL["z"] and col.broad_phase == auto
                   and scene.total_qp == 2048 and xyz.shape[0] == 2000,
                   f"config-5 path: eager and graph finite, flags 0, no "
                   f"resize, no kernel launched, the renderable mean height "
                   f"fell and stayed above the floor at 0 (lowest means "
                   f"{[round(float(r['heights'].min()), 4) for r in runs.values()]}); "
                   f"broad phase {col.broad_phase} = the auto rule's "
                   f"{auto}; graph vs eager after {steps} steps: max |dz| / "
                   f"max|z| {z_err:.3e}, max |d(B z)| / max|B z| "
                   f"{bz_err:.3e}; peak {peak / 2 ** 20:.1f} MiB")

        grid, *_ = ex.build(ex.BENCH, "cuda", vol_pts=vol,
                            collisions={"broad_phase": "grid"})
        gcol = grid.force_dict["collision"]["object"]
        out = {}
        for label, s in (("auto", scene), ("grid", grid)):
            fn, consts = s.build_functional_step(with_diag=True)
            with torch.no_grad():
                z1, _, _, fl = fn(consts, *runs["eager"]["state"])
            out[label] = (B @ z1.to(torch.float64), int(fl))
        g_err = float((out["auto"][0] - out["grid"][0]).abs().max()
                      / out["auto"][0].abs().max())
        self.check(gcol.broad_phase == "grid" and g_err <= GAUSS_TOL["z"]
                   and out["grid"][1] == 0,
                   f"config-5 step with the grid broad phase (dims "
                   f"{gcol.grid_dims}, K {gcol.cell_capacity}, M "
                   f"{gcol.max_occupied_cells}) against {col.broad_phase} "
                   f"from the eager path's last state: max |d(B z)| / "
                   f"max|B z| {g_err:.3e}, flags {out['grid'][1]}")
        del grid

        shell = self.gauss_shells()["bench"]
        *_, center, dmax = self.gauss_normalized(shell)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with self.densifier_warnings() as warned, \
                self.carve_split() as split:
            pts = sample_points_in_volume(*shell)
        torch.cuda.synchronize()
        carve_s = time.perf_counter() - t0
        carve_peak = torch.cuda.max_memory_allocated() - base
        p = pts.cpu().numpy().astype(np.float64)
        r = np.linalg.norm(p - center, axis=1)
        share = float((r < 0.25 * dmax).mean())
        # a fill of uniform density puts (0.25 dmax / r_max)³ of the
        # samples there; a shell alone, none
        uniform = (0.25 * dmax / r.max()) ** 3
        inside = bool(((p > shell[0].min(0)) & (p < shell[0].max(0))).all())
        print(f"config 5, the densifier at its defaults (level 8, carving "
              f"from 86 views at 256², jitter, no subsample): "
              f"{pts.shape[0]} points in {carve_s:.3f} s host wall, peak "
              f"{carve_peak / 2 ** 20:.1f} MiB above {base / 2 ** 20:.1f} "
              f"MiB held; of it " + "; ".join(
                  f"{k} {v:.3f} s" for k, v in split.items())
              + f" [{self.card}]", flush=True)
        self.check(not warned and share > 0.5 * uniform and inside
                   and pts.device.type == "cuda" and split["views"] > 0,
                   f"config-5 level-8 carve: {len(warned)} fallback "
                   f"warnings, interior share (r < 0.25 dmax) {share:.4f} "
                   f"above half of a uniform fill's {uniform:.4f}, every "
                   f"sample inside the gaussians' box {inside}")
        self.gauss.update(scene=scene, idx=idx, start=start, xyz=xyz,
                          carve_s=carve_s, carve_peak=carve_peak,
                          path_peak=peak, split=split)

    @contextlib.contextmanager
    def carve_split(self):
        """The densifier's carve timed in its parts while inside: the
        voxelization, the raytraced views (each frame of the dataset),
        bf_recon without them and the query, host seconds with the card
        synced around each → {part: s}."""
        torch = self.torch
        from kaolin_tpu_torch.ops.gaussians import densifier
        from kaolin_tpu_torch.ops.spc import raytraced_spc_dataset as rds
        bfr = sys.modules["kaolin_tpu_torch.ops.spc.bf_recon"]
        split = dict(voxelization=0.0, views=0.0, bf_recon=0.0, query=0.0)
        patched = [(densifier, "gs_to_voxelgrid", "voxelization"),
                   (rds.RayTracedSPCDataset, "__getitem__", "views"),
                   (bfr, "bf_recon", "bf_recon"),
                   (bfr, "unbatched_query", "query")]
        originals = [getattr(obj, name) for obj, name, _ in patched]

        def timed(fn, part):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                split[part] += time.perf_counter() - t0
                return out
            return run

        for (obj, name, part), fn in zip(patched, originals):
            setattr(obj, name, timed(fn, part))
        try:
            yield split
        finally:
            for (obj, name, _), fn in zip(patched, originals):
                setattr(obj, name, fn)
            split["bf_recon"] -= split["views"]   # the frames are made in it

    def gauss_window_ms(self, graphs, reps=3):
        """ms/step of a 100-step rollout window from the path's start,
        CUDA events, median of ``reps`` after a warm window; and the Newton
        iterations a step."""
        torch, ex, g = self.torch, self.gauss_ex, self.gauss
        scene, steps = g["scene"], ex.BENCH["steps"]
        times = []
        before = self.newton.iterations
        for rep in range(reps + 1):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in g["start"])
            scene.use_cuda_graphs = graphs
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            ex.rollout(scene, g["idx"], steps)
            b.record()
            b.synchronize()
            if rep:
                times.append(a.elapsed_time(b) / steps)
        iters = (self.newton.iterations - before) / ((reps + 1) * steps)
        return statistics.median(times), iters

    def phase_gauss_timing(self):
        """Config 5 on the card: the 100-step window eager and from the
        graph (ms/step, CUDA events, median of 3 windows from the path's
        start); a step's profile eager and as a replay (device busy, idle
        share, largest ops) and the LBS move; the step's bound; the flood
        fill densifier at level 6 with gs_to_voxelgrid's share, each with
        its peak memory; the shares of phase_gauss_path's level-8 carve
        (voxelization, the 86 raytraced views, bf_recon, the query)."""
        torch, ex, g = self.torch, self.gauss_ex, self.gauss
        from kaolin_tpu_torch.ops.conversions import gs_to_voxelgrid
        self.check_precision("phase_gauss_timing")
        if "scene" not in g:
            raise RuntimeError("phase_gauss_path did not run")
        scene, idx = g["scene"], g["idx"]
        e_ms, e_iters = self.gauss_window_ms(False)
        g_ms, _ = self.gauss_window_ms(True)
        g.update(eager_ms=e_ms, graph_ms=g_ms, iterations=e_iters)
        print(f"config-5 step in the 100-step window (LBS move included), "
              f"medians of 3 windows: eager {e_ms:.4f} ms "
              f"({e_iters:.2f} Newton iterations a step), graph "
              f"{g_ms:.4f} ms [{self.card}]", flush=True)
        scene.use_cuda_graphs = False
        g["eager_busy"] = self.profile_path(
            "config-5 step, eager", (), scene.run_sim_step)
        scene.use_cuda_graphs = True
        g["graph_busy"] = self.profile_path(
            "config-5 step, graph replay", (), scene.run_sim_step)
        self.profile_path("config-5 LBS move of 2,000 gaussians", (),
                          lambda: scene.get_object_deformed_pts(
                              idx, points="rendered"))
        self.gauss_bound()

        shell = self.gauss_shells()["bench"]
        nrm = self.gauss_normalized(shell)[:4]
        parts = {}
        for label, fn in (
                ("the flood-fill densifier", lambda: ex.densify(
                    shell, ex.BENCH["num_samples"], "cuda")),
                ("its gs_to_voxelgrid", lambda: gs_to_voxelgrid(
                    *nrm, level=6, device="cuda"))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            parts[label] = statistics.median(times)
            print(f"config 5, {label} at level 6: {1e3 * parts[label]:.3f} "
                  f"ms host wall (synced, median of 3), peak "
                  f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 20:.1f}"
                  f" MiB above what was held [{self.card}]", flush=True)
        split = g["split"]
        print(f"config 5: gs_to_voxelgrid's share of the level-6 flood fill "
              f"{parts['its gs_to_voxelgrid'] / parts['the flood-fill densifier']:.3f}"
              f"; the level-8 carve {g['carve_s']:.3f} s (peak "
              f"{g['carve_peak'] / 2 ** 20:.1f} MiB): " + ", ".join(
                  f"{k} {v / g['carve_s']:.3f}" for k, v in split.items())
              + f" of it [{self.card}]", flush=True)

    def gauss_bound(self):
        """The config-5 step's bound, reckoned as config 1's is
        (``sim_bound``: the dense products and factorizations per Newton
        iteration over 67 TFLOP/s; bytes: B, dF/dz and BMB read once), plus
        the dense broad phase's N(N-1)/2 pair tests at 19 operations each
        once a step; the contact terms are not counted."""
        g, scene = self.gauss, self.gauss["scene"]
        d, n, m = scene.total_dofs, scene.total_qp, scene.max_ls_steps
        per_iter = sum(dense_step_ops(d, n, m))
        detect = 19 * n * (n - 1) // 2
        nbytes = 4 * (12 * n * d + d * d)
        for label, iters, ms in (
                ("graph (fixed trip)", scene.max_newton_steps,
                 g.get("graph_busy")),
                ("eager (stops early)", g["iterations"], g.get("eager_busy"))):
            ops = per_iter * iters + detect
            t_ops = ops / FP32_OPS_S * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            busy = "not measured" if ms is None else \
                f"{ms:.4f} ms, share {bound / ms:.4f}"
            print(f"config-5 sim step, {label}: {iters:g} Newton iterations "
                  f"x {per_iter / 1e9:.4f} GFLOP + {detect / 1e6:.1f} M "
                  f"detection = {ops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms; "
                  f"{nbytes} bytes -> {t_bytes:.6f} ms; bound {bound:.6f} ms "
                  f"by {'operations' if t_ops >= t_bytes else 'bytes'}; "
                  f"device busy {busy} [{self.card}]")

    # -- the full render (examples/torch_easy_render.py) ------------------
    def render_errs(self, card, cpu):
        """(face_idx equal, {pass: max|card − cpu| / max(max|cpu|, 1)})."""
        torch = self.torch
        same = torch.equal(card["face_idx"].cpu(), cpu["face_idx"])
        errs = {k: float((card[k].detach().cpu() - v.detach()).abs().max())
                / max(float(v.detach().abs().max()), 1.0)
                for k, v in cpu.items() if k != "face_idx"}
        return same, errs

    @contextlib.contextmanager
    def winner_inputs(self):
        """Inside, the rasterizer's dispatch to #1 keeps its arguments →
        the list of them, one a search."""
        rast, search, seen = self.rast, self.rast._rasterize_search, []

        def keep(*args):
            seen.append(args)
            return search(*args)

        rast._rasterize_search = keep
        try:
            yield seen
        finally:
            rast._rasterize_search = search

    @staticmethod
    def maps_sampled(mesh):
        """#7's forward launches in one ``render_mesh`` of ``mesh`` (which
        has UVs): one a texture map its materials hold."""
        return sum(getattr(m, a, None) is not None for m in mesh.materials
                   for a in SAMPLED_MAPS)

    def texture_launches(self, n, fwd, bwd=0):
        """Whether the launches ``n`` hold exactly ``fwd`` #7 forwards and
        ``bwd`` backwards, and one #8 forward a winner search, with at most
        as many backwards."""
        return ((n["texture_fwd"], n["texture_bwd"]) == (fwd, bwd)
                and n["regather_fwd"] == n["winner"]
                and n["regather_bwd"] <= n["regather_fwd"])

    def check_winner_at(self, label, render):
        """``render`` once keeping #1's inputs, then #1 on them against
        ``rasterize_search_plain`` on the same CUDA tensors: the winner ids
        equal, at the shape the path gives the kernel."""
        torch = self.torch
        with torch.no_grad(), self.winner_inputs() as seen:
            render()
        bad = hits = 0
        for fvz, fvi, valid, *rest in seen:
            ids_k = self.cr.rasterize_search_cuda(
                fvz.contiguous(), fvi.contiguous(), valid.contiguous(), *rest)
            ids_p = self.rast.rasterize_search_plain(fvz, fvi, valid, *rest)
            bad += int((ids_k != ids_p).sum())
            hits += int((ids_p >= 0).sum())
            self.record_err("winner", float((ids_k - ids_p).abs().max()))
        faces = seen[0][1].shape[1] if seen else 0
        self.check(len(seen) == 1 and bad == 0 and hits > 0,
                   f"winner ids exact at {label} ({faces} faces, "
                   f"{len(seen)} search), the kernel against "
                   f"rasterize_search_plain on the same CUDA tensors: {bad} "
                   f"differ ({hits} covered)")

    def phase_render_parity(self):
        """The full render on the card against the port's CPU: the
        two-material scene at 512² (face_idx equal, every pass within 1e-5
        of its max|x|); one fit step at 256² (its loss within 1e-5 relative,
        its gradients within 1e-4 of max|g|); DefTet at 128² with knum 300
        from the CPU's inputs (face_idx equal, features within 1e-6); the
        32-lobe environment fit (amplitudes within 1e-4 of the largest,
        lobes within 1e-6); and F28: the card's mesh re-set to new vertices
        equal to a fresh mesh, every derived attribute."""
        torch, ex = self.torch, self.render_ex
        from kaolin_tpu_torch.rep import SurfaceMesh
        self.check_precision("phase_render_parity")
        tol = RENDER_TOL
        devices = {"card": self.device, "cpu": "cpu"}
        meshes = {k: ex.scene(d) for k, d in devices.items()}
        with torch.no_grad():
            same, errs = self.render_errs(ex.render(meshes["card"]),
                                          ex.render(meshes["cpu"]))
        self.check(same and max(errs.values()) <= tol["pass"],
                   f"render at {RENDER_RES}x{RENDER_RES} card vs CPU: "
                   f"face_idx {'equal' if same else 'DIFFERS'}; passes "
                   + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items()))
                   + f" of max|x| (<= {tol['pass']:g})")
        grads, losses = {}, {}
        for k, d in devices.items():
            state = ex.fit_setup(d, RENDER_GRAD_RES)
            loss, _ = ex.fit_loss(state)
            loss.backward()
            losses[k] = float(loss.detach())
            grads[k] = {n: p.grad.cpu() for n, p in state["params"].items()}
        gerr = {n: float((grads["card"][n] - g).abs().max())
                / float(g.abs().max()) for n, g in grads["cpu"].items()}
        lerr = abs(losses["card"] - losses["cpu"]) / losses["cpu"]
        self.check(lerr <= tol["pass"] and max(gerr.values()) <= tol["grad"],
                   f"fit step at {RENDER_GRAD_RES}x{RENDER_GRAD_RES} card vs "
                   f"CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} "
                   f"(rel {lerr:.2e}); gradients "
                   + ", ".join(f"{n} {v:.2e}" for n, v in gerr.items())
                   + f" of max|g| (<= {tol['grad']:g})")
        inputs = ex.deftet_inputs(meshes["cpu"], RENDER_DEFTET_PARITY)
        on_card = {k: ([x.to(self.device) for x in v] if isinstance(v, list)
                       else v.to(self.device)) for k, v in inputs.items()}
        with torch.no_grad():
            (uv_h, z_h), idx_h = ex.deftet_render(inputs)
            (uv_c, z_c), idx_c = ex.deftet_render(on_card)
        same = torch.equal(idx_c.cpu(), idx_h)
        ferr = max(float((uv_c.cpu() - uv_h).abs().max()),
                   float((z_c.cpu() - z_h).abs().max()))
        self.check(same and ferr <= tol["feature"],
                   f"DefTet at {RENDER_DEFTET_PARITY}x{RENDER_DEFTET_PARITY}, "
                   f"knum {ex.KNUM}, card vs CPU from one set of inputs: "
                   f"face_idx {'equal' if same else 'DIFFERS'} "
                   f"({int((idx_h >= 0).sum())} hits), features within "
                   f"{ferr:.2e} (<= {tol['feature']:g})")
        env = {k: ex.environment_lighting(d) for k, d in devices.items()}
        amp = env["cpu"].amplitude
        aerr = float((env["card"].amplitude.cpu() - amp).abs().max()) \
            / float(amp.abs().max())
        lerr = max(float((getattr(env["card"], k).cpu()
                          - getattr(env["cpu"], k)).abs().max())
                   for k in ("direction", "sharpness"))
        self.check(aerr <= tol["env"] and lerr <= tol["feature"],
                   f"from_environment_map ({ex.NUM_SG} lobes, "
                   f"{ex.ENV[0]}x{ex.ENV[1]} map) card vs CPU: amplitudes "
                   f"within {aerr:.2e} of the largest (<= {tol['env']:g}), "
                   f"lobes within {lerr:.2e}")
        # vertex normals and tangents sum faces by index_add, whose atomics
        # add in any order on the card: held within 1e-6, where a stale
        # attribute (the old geometry's) is off by more than 1e-2
        mesh = meshes["card"]
        derived = ("face_vertices", "face_normals", "vertex_normals",
                   "vertex_tangents", "face_tangents", "face_features")
        old = {a: getattr(mesh, a) for a in derived}
        v2 = mesh.vertices * mesh.vertices.new_tensor([1.1, 0.9, 1.05]) \
            + 0.02
        mesh.vertices = v2
        fresh = SurfaceMesh(vertices=v2, faces=mesh.faces,
                            face_uvs=mesh.face_uvs,
                            vertex_features=mesh.vertex_features)
        err = {a: float((getattr(mesh, a) - getattr(fresh, a)).abs().max())
               for a in derived}
        stale = {a: float((old[a] - getattr(fresh, a)).abs().max())
                 for a in derived if a != "face_features"}
        self.check(max(err.values()) <= tol["feature"]
                   and min(stale.values()) > 1e-2,
                   "F28: the card's mesh with its vertices re-set against a "
                   "fresh mesh: " + ", ".join(f"{a} {v:.2e}"
                                              for a, v in err.items())
                   + f" (<= {tol['feature']:g}); the old geometry's "
                   "attributes off by " + ", ".join(
                       f"{a} {v:.2e}" for a, v in stale.items()))

    def phase_render_path(self):
        """The full render on the card, each piece driven with every launch
        counter set to 0 just before and read just after: the render at
        512² (ten passes, finite) and under 32 environment lobes launch #1
        once, #7's forward once a texture map of the scene's materials
        (easy_render's ``tex_sample``) and no other kernel; the fit's 100
        steps (each sets the vertices, renders, backward, Adam) launch #1
        and #7 both ways once a map on every step and nothing else, every
        loss finite and the last below half the first; DefTet at its
        defaults at 512² (knum 300, face_chunk 1,024, pixel_chunk 8,192)
        with depths non-increasing along knum wherever face_idx ≥ 0 and
        hits packed first; the three tutorials at full size, each with its
        own checks, launching #1 and nothing else."""
        torch, ex, r = self.torch, self.render_ex, self.render
        names = list(self.counters())
        others = [k for k in names
                  if k not in ("winner", *TEXTURE_KERNELS, *REGATHER_KERNELS)]

        def only_winner(n, maps, backward=False):
            return (n["winner"] == 1 and not any(n[k] for k in others)
                    and self.texture_launches(n, maps,
                                              maps if backward else 0))

        mesh = ex.scene("cuda")
        maps = self.maps_sampled(mesh)
        with torch.no_grad():
            passes, n = self.drive(names, lambda: ex.render(mesh))
            env, n_env = self.drive(names, lambda: ex.env_render(mesh))
        finite = all(bool(torch.isfinite(v.float()).all())
                     for v in (*passes.values(), *env.values()))
        covered = int((passes["face_idx"] >= 0).sum())
        self.check(len(passes) == 10 and finite and covered > 0
                   and only_winner(n, maps) and only_winner(n_env, maps),
                   f"render at {RENDER_RES}x{RENDER_RES}: {len(passes)} "
                   f"passes, {covered} covered pixels, finite; launches "
                   f"{n} ({maps} texture maps); under {ex.NUM_SG} lobes "
                   f"{n_env}")
        state = ex.fit_setup("cuda", RENDER_RES)
        fit_maps = self.maps_sampled(state["mesh"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, counts = [], []
        for _ in range(RENDER_STEPS):
            loss, n = self.drive(names, lambda: ex.fit_step(state))
            losses.append(float(loss))
            counts.append(n)
        r["fit_s"] = time.perf_counter() - t0
        r["losses"] = losses
        self.check(all(only_winner(c, fit_maps, True) for c in counts),
                   f"fit: every one of {RENDER_STEPS} steps launched #1 once, "
                   f"#7 {fit_maps} times each way ({fit_maps} texture maps) "
                   "and #2-6 never (totals " + ", ".join(
                       f"{k} {sum(c[k] for c in counts)}" for k in names)
                   + ")")
        self.check(bool(np.isfinite(losses).all())
                   and losses[-1] < 0.5 * losses[0],
                   f"fit: L1 {losses[0]:.5f} -> {losses[-1]:.5f} in "
                   f"{RENDER_STEPS} steps (below half the start), "
                   f"{r['fit_s']:.2f} s host with a sync a step")
        inputs = ex.deftet_inputs(mesh)
        with torch.no_grad():
            ((uv, z), idx), n = self.drive(names,
                                           lambda: ex.deftet_render(inputs))
        z = z[..., 0]
        hit = idx >= 0
        ordered = bool(((z[..., :-1] >= z[..., 1:]) | ~hit[..., 1:]).all())
        packed = bool((hit[..., :-1] | ~hit[..., 1:]).all())
        r["deftet_hits"] = int(hit.sum())
        self.check(ordered and packed and not any(n.values())
                   and r["deftet_hits"] > 0,
                   f"DefTet at its defaults at {RENDER_RES}x{RENDER_RES} "
                   f"(knum {ex.KNUM}): {r['deftet_hits']} hits, up to "
                   f"{int(hit.sum(-1).max())} a pixel, depths non-increasing "
                   f"along knum {ordered}, hits first {packed}; launches {n}")
        for name in ("torch_tutorial_easy_mesh_render",
                     "torch_tutorial_diffuse_lighting",
                     "torch_tutorial_sg_specular_lighting"):
            mod = load_example(name)
            t0 = time.perf_counter()
            _, n = self.drive(names, lambda: mod.main("cuda"))
            self.check(n["winner"] > 0 and not any(n[k] for k in others)
                       and self.texture_launches(n, 0),
                       f"{name} at full size passed its checks in "
                       f"{time.perf_counter() - t0:.2f} s; launches {n}")

    def peak_mib(self, fn):
        """MiB that ``fn`` allocates above what was held before it."""
        torch = self.torch
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def render_bound(self, label, tensors, ops, busy=None):
        """The least time for ``ops`` float32 operations and for moving
        ``tensors`` (each read or written once) → (bound ms, by what)."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / FP32_OPS_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        share = "" if busy is None else \
            f"; device busy {busy:.4f} ms, share {bound / busy:.5f}"
        print(f"{label} bound: {nbytes} bytes -> {t_bytes:.6f} ms, "
              f"{ops / 1e6:.1f} M operations -> {t_ops:.6f} ms; "
              f"{bound:.6f} ms by {by}{share} [{self.card}]", flush=True)
        return bound, by

    def mesh_tensors(self, mesh):
        """The render's inputs: the mesh's given tensors and its
        materials' textures and values."""
        out = [mesh.get_attribute(a) for a in ("vertices", "faces",
                                               "vertex_features", "face_uvs",
                                               "material_assignments")]
        for m in mesh.materials:
            out += [t for a in m.get_attributes(only_tensors=True)
                    for t in [getattr(m, a)]]
        return out

    def phase_render_timing(self):
        """The full render's times on the card: the render at 512² at 4,992
        and at 81,408 faces (CUDA events, median of 10; device busy, idle
        share, the largest ops and #1's share; peak memory; bound), the
        81,408-face set-up once (scene, render, environment fit and render,
        host wall, synced) and #1's winner ids at that shape against its
        plain version on the same CUDA tensors, the render under 32 environment lobes (ms,
        peak), the fit step (forward, backward, Adam: ms, profile, peak,
        bound) and DefTet at its defaults (ms, median of 3; peak)."""
        torch, ex, r = self.torch, self.render_ex, self.render
        self.check_precision("phase_render_timing")
        res = RENDER_RES
        pixels = res * res
        light = ex.default_lighting("cuda")
        for label, size in (("4,992 faces", (ex.N_LAT, ex.N_LON)),
                            ("81,408 faces", ex.ASSET)):
            if size == ex.ASSET:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mesh = ex.scene("cuda", *size)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with torch.no_grad():
                    ex.render(mesh)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    env = ex.environment_lighting("cuda")
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    ex.env_render(mesh, env)
                    torch.cuda.synchronize()
                    t4 = time.perf_counter()
                print(f"set-up at {label}, once, host wall synced: scene "
                      f"{t1 - t0:.4f} s, first render {t2 - t1:.4f} s, "
                      f"environment fit {t3 - t2:.4f} s, first environment "
                      f"render {t4 - t3:.4f} s [{self.card}]", flush=True)
                self.check_winner_at(f"{label} at {res}²",
                                     lambda: ex.render(mesh))
            else:
                mesh = ex.scene("cuda", *size)
            with torch.no_grad():
                fn = lambda: ex.render(mesh, light)  # noqa: E731
                ms = statistics.median(self.time_ms(fn, RENDER_TIMED))
                peak = self.peak_mib(fn)
                busy, kms = self.profile_path(
                    f"render at {res}x{res}, {label}", ("winner",), fn,
                    record=False)
                out = fn()
            r[label] = dict(ms=ms, peak=peak, busy=busy,
                            winner=kms["winner"])
            print(f"render at {res}x{res}, {label}: {ms:.4f} ms (CUDA "
                  f"events, median of {RENDER_TIMED}); #1 "
                  f"{kms['winner']:.4f} device ms, {kms['winner'] / busy:.4f}"
                  f" of busy; peak {peak:.1f} MiB [{self.card}]", flush=True)
            self.render_bound(
                f"render at {res}x{res}, {label}",
                self.mesh_tensors(mesh) + list(out.values()),
                pixels * RENDER_PIXEL_OPS, busy)

        mesh = ex.scene("cuda")
        env = ex.environment_lighting("cuda")
        with torch.no_grad():
            fn = lambda: ex.env_render(mesh, env)  # noqa: E731
            ms = statistics.median(self.time_ms(fn, RENDER_TIMED))
            peak = self.peak_mib(fn)
        r["env"] = dict(ms=ms, peak=peak)
        print(f"render at {res}x{res} under {ex.NUM_SG} environment lobes: "
              f"{ms:.4f} ms (CUDA events, median of {RENDER_TIMED}); peak "
              f"{peak:.1f} MiB [{self.card}]", flush=True)

        state = ex.fit_setup("cuda", res)
        for _ in range(5):
            ex.fit_step(state)
        fn = lambda: ex.fit_step(state)  # noqa: E731
        ms = statistics.median(self.time_ms(fn, RENDER_TIMED))
        peak = self.peak_mib(fn)
        busy, _ = self.profile_path(f"fit step at {res}x{res}", ("winner",),
                                    fn, record=False)
        r["step"] = dict(ms=ms, peak=peak, busy=busy)
        print(f"fit step at {res}x{res} (render, L1, backward, Adam): "
              f"{ms:.4f} ms (CUDA events, median of {RENDER_TIMED}); peak "
              f"{peak:.1f} MiB [{self.card}]", flush=True)
        params = list(state["params"].values())
        n_params = sum(p.numel() for p in params)
        with torch.no_grad():
            out = ex.render(state["mesh"])
        # Adam reads a parameter, its gradient and both moments and writes
        # the parameter and the moments
        self.render_bound(
            f"fit step at {res}x{res}",
            self.mesh_tensors(state["mesh"]) + list(out.values())
            + [state["target"]] + params * 7,
            3 * pixels * RENDER_PIXEL_OPS + ADAM_OPS * n_params, busy)

        inputs = ex.deftet_inputs(mesh)
        with torch.no_grad():
            fn = lambda: ex.deftet_render(inputs)  # noqa: E731
            ms = statistics.median(self.time_ms(fn, 3))
            peak = self.peak_mib(fn)
        r["deftet"] = dict(ms=ms, peak=peak)
        print(f"DefTet at its defaults at {res}x{res} (knum {ex.KNUM}, "
              f"4,992 faces streamed in chunks of 1,024, 8,192 pixels a "
              f"block): {ms:.4f} ms (CUDA events, median of 3); peak "
              f"{peak:.1f} MiB [{self.card}]", flush=True)

    # -- the asset from disk (examples/torch_asset_render.py) -------------
    def asset_errs(self, meshes, a):
        """How far the imports are from the arrays written: the OBJ's
        geometry and materials, the PLY's and OFF's exactly (0 or 1 for
        equal or not), the GLB's face vertices, face UVs and normal
        directions as max|x − y| / max|y|, its faces' materials exactly."""
        ex, torch = self.asset_ex, self.torch

        def diff(x, want, exact=True):
            x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            want = np.asarray(want)
            if x.shape != want.shape:
                return float("inf")
            if exact:
                return float(not np.array_equal(x, want))
            return float(np.abs(x - want).max()) / float(np.abs(want).max())

        obj, ref = meshes["obj"], ex.obj_reference(a, "cpu")
        errs = {f"obj.{k}": diff(obj.get_attribute(k), ref.get_attribute(k))
                for k in ("vertices", "faces", "uvs", "face_uvs_idx",
                          "material_assignments")}
        for i, (got, want) in enumerate(zip(obj.materials, ref.materials)):
            errs[f"obj.material{i}"] = float(
                got.get_attributes() != want.get_attributes()) + sum(
                diff(getattr(got, k), getattr(want, k))
                for k in want.get_attributes(only_tensors=True))
        for fmt in ("ply", "off"):
            errs[f"{fmt}.vertices"] = diff(meshes[fmt].vertices,
                                           a["vertices"])
            errs[f"{fmt}.faces"] = diff(meshes[fmt].faces, a["faces"])
        errs["ply.colors"] = diff(meshes["ply"].vertex_colors,
                                  (a["normals"] + 1.0) / 2.0)
        glb = meshes["glb"]
        n = glb.face_normals
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        errs.update({
            "glb.face_vertices": diff(glb.face_vertices,
                                      a["vertices"][a["faces"]], False),
            "glb.face_uvs": diff(glb.face_uvs, a["uvs"][a["face_uvs_idx"]],
                                 False),
            "glb.normals": diff(n, a["normals"][a["faces"]], False),
            "glb.material_assignments": diff(glb.material_assignments,
                                             a["material_assignments"])})
        return errs

    def asset_ok(self, errs):
        return all(v <= (IO_TOL["glb"] if k.startswith("glb.")
                         and k != "glb.material_assignments" else 0.0)
                   for k, v in errs.items())

    def gcn_pair(self, mesh_card, mesh_cpu):
        """``graph_conv`` of the example on the card and on the CPU from
        one set of weights (made on the CPU, copied) → ((loss, grads) of
        the card, of the CPU)."""
        ex = self.asset_ex
        out = []
        step_h, layers_h, _, _ = ex.graph_conv(mesh_cpu)
        step_c, layers_c, _, _ = ex.graph_conv(mesh_card)
        layers_c.load_state_dict(layers_h.state_dict())
        for step, layers in ((step_c, layers_c), (step_h, layers_h)):
            loss = step()
            out.append((loss.cpu(), {n: p.grad.cpu()
                                     for n, p in layers.named_parameters()}))
        return out

    def gcn_forward(self, mesh, layers):
        """The example's layers' forward on ``mesh`` (B = 4) → out."""
        ex, torch = self.asset_ex, self.torch
        _, _, feats, adj = ex.graph_conv(mesh)
        h = feats
        with torch.no_grad():
            for i, layer in enumerate(layers):
                h = layer(h, adj, normalize_adj=True)
                if i < len(layers) - 1:
                    h = torch.relu(h)
        return h

    def phase_io_parity(self):
        """The asset path's pieces on the card against the port's CPU, on a
        small copy of the asset (40 x 64 sphere, 128² maps, 4,096
        gaussians): the OBJ and GLB imports rendered at 64² (face_idx
        equal, every pass within 1e-5 of its max|x|); the imported OBJ's
        render against ``obj_reference`` (the geometry and the MTL's
        materials built in memory, maps at 8 bits) on the card (face_idx
        equal, passes within 1e-5); ``GraphConv`` from one set of weights
        (forward within 1e-5 relative, gradients within 1e-4 of max|g|);
        the transform of an imported 3DGS cloud within 1e-6 of max|x|."""
        import tempfile

        torch, ex, p = self.torch, self.asset_ex, IO_PARITY
        self.check_precision("phase_io_parity")
        with tempfile.TemporaryDirectory() as d:
            paths, a = ex.write_asset(d, p["asset"], p["tex"])
            meshes = {dev: ex.import_asset(paths, dev)
                      for dev in ("cuda", "cpu")}
            with torch.no_grad():
                for fmt in ("obj", "glb"):
                    same, errs = self.render_errs(
                        ex.render_asset(meshes["cuda"][fmt], p["res"]),
                        ex.render_asset(meshes["cpu"][fmt], p["res"]))
                    self.check(same and max(errs.values()) <= IO_TOL["pass"],
                               f"{fmt.upper()} import rendered at "
                               f"{p['res']}² card vs CPU: face_idx "
                               f"{'equal' if same else 'DIFFERS'}; passes "
                               + ", ".join(f"{k} {v:.2e}" for k, v in
                                           sorted(errs.items()))
                               + f" of max|x| (<= {IO_TOL['pass']:g})")
                card = ex.render_asset(meshes["cuda"]["obj"], p["res"])
                ref = ex.render_asset(ex.obj_reference(a, "cuda"), p["res"])
                same, errs = self.render_errs(
                    card, {k: v.cpu() for k, v in ref.items()})
            self.check(same and max(errs.values()) <= IO_TOL["pass"],
                       f"OBJ import against the same mesh built in memory, "
                       f"{p['res']}² on the card: face_idx "
                       f"{'equal' if same else 'DIFFERS'}; passes "
                       + ", ".join(f"{k} {v:.2e}" for k, v in
                                   sorted(errs.items()))
                       + f" (<= {IO_TOL['pass']:g})")
            (loss_c, g_c), (loss_h, g_h) = self.gcn_pair(
                meshes["cuda"]["obj"], meshes["cpu"]["obj"])
            gerr = {n: float((g_c[n] - g).abs().max()) / float(
                g.abs().max()) for n, g in g_h.items()}
            _, layers, _, _ = ex.graph_conv(meshes["cpu"]["obj"])
            out_h = self.gcn_forward(meshes["cpu"]["obj"], layers)
            out_c = self.gcn_forward(meshes["cuda"]["obj"],
                                     copy.deepcopy(layers).to("cuda"))
            ferr = float((out_c.cpu() - out_h).abs().max()) / float(
                out_h.abs().max())
            self.check(ferr <= IO_TOL["gcn"]
                       and max(gerr.values()) <= IO_TOL["gcn_grad"],
                       f"GraphConv {ex.GCN_WIDTHS} at B = {ex.GCN_BATCH} on "
                       f"the small asset's graph card vs CPU: forward "
                       f"{ferr:.2e} of max|x| (<= {IO_TOL['gcn']:g}); loss "
                       f"{float(loss_c):.6g} vs {float(loss_h):.6g}; "
                       "gradients " + ", ".join(
                           f"{n} {v:.2e}" for n, v in gerr.items())
                       + f" of max|g| (<= {IO_TOL['gcn_grad']:g})")
            scenes = {}
            for name, dev in (("card", "cuda"), ("host", "cpu")):
                os.makedirs(os.path.join(d, name))
                scenes[name] = ex.gaussian_scene(os.path.join(d, name),
                                                 p["gaussians"], dev)
            terr = {k: float((getattr(scenes["card"]["moved"], k).cpu()
                              - getattr(scenes["host"]["moved"], k))
                             .abs().max())
                    / float(getattr(scenes["host"]["moved"], k).abs().max())
                    for k in ("positions", "orientations", "scales",
                              "sh_coeff")}
            self.check(max(terr.values()) <= IO_TOL["gauss"],
                       f"transform of {p['gaussians']} imported gaussians "
                       "card vs CPU: " + ", ".join(
                           f"{k} {v:.2e}" for k, v in terr.items())
                       + f" of max|x| (<= {IO_TOL['gauss']:g})")

    def phase_io_path(self):
        """The asset path at full size on the card, each piece with every
        launch counter set to 0 before and read after: the 81,408-face
        asset with its 1,024² maps written as OBJ, GLB, PLY and OFF and
        imported (the imports equal what was written, the GLB's within
        1e-6); the OBJ and GLB imports rendered at 512², finite, #1 once
        each, #7's forward once a texture map of the import's materials
        (easy_render's ``tex_sample``) and no other kernel, and #1's winner
        ids for each against its plain
        version on the same CUDA tensors; the OBJ's render against the
        CPU's render of the CPU's import of the same file (face_idx equal,
        every pass within 1e-5 of its max|x|); 2^20 gaussians exported, imported,
        transformed, exported and imported again (positions and SH bit for
        bit, quaternions bit for bit as the import normalizes them and
        within 1e-6 relative, opacities and scales within 1e-6 relative);
        the 64-model ShapeNetV2 tree through ``CachedDataset`` on 4
        spawned workers (no fallback) equal to the serial loop's caches,
        stacked on the card; GraphConv at width forward and backward,
        finite, its parameters and the seeded generators of ``ops.random``
        and ``utils.testing`` made on the card by default; the meshes
        tutorial at full size."""
        import tempfile
        import warnings

        torch, ex, r = self.torch, self.asset_ex, self.io
        names = list(self.counters())
        others = [k for k in names
                  if k not in ("winner", *TEXTURE_KERNELS, *REGATHER_KERNELS)]
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            paths, a = ex.write_asset(d)
            r["write_s"] = time.perf_counter() - t0
            r["bytes"] = {fmt: os.path.getsize(p) for fmt, p in paths.items()}
            meshes, n = self.drive(names, lambda: ex.import_asset(paths))
            errs = self.asset_errs(meshes, a)
            self.check(self.asset_ok(errs) and not any(n.values())
                       and meshes["obj"].vertices.is_cuda,
                       f"the {a['faces'].shape[0]}-face asset written in "
                       f"{r['write_s']:.2f} s ({r['bytes']} bytes) and "
                       "imported on the card: " + ", ".join(
                           f"{k} {v:.2e}" for k, v in errs.items())
                       + f" (0, the GLB's <= {IO_TOL['glb']:g}); launches "
                       f"{n}")
            with torch.no_grad():
                for fmt in ("obj", "glb"):
                    passes, n = self.drive(
                        names, lambda: ex.render_asset(meshes[fmt]))
                    finite = all(bool(torch.isfinite(v.float()).all())
                                 for v in passes.values())
                    covered = int((passes["face_idx"] >= 0).sum())
                    maps = self.maps_sampled(meshes[fmt])
                    self.check(finite and covered > 0 and n["winner"] == 1
                               and not any(n[k] for k in others)
                               and self.texture_launches(n, maps),
                               f"{fmt.upper()} import rendered at "
                               f"{RENDER_RES}²: {len(passes)} passes, "
                               f"{covered} covered pixels, finite; launches "
                               f"{n} ({maps} texture maps)")
                    self.check_winner_at(
                        f"the {fmt.upper()} import at {RENDER_RES}²",
                        lambda: ex.render_asset(meshes[fmt]))
                t0 = time.perf_counter()
                host = self.kio.import_mesh(paths["obj"], with_materials=True,
                                            raw_materials=False, device="cpu")
                same, errs = self.render_errs(ex.render_asset(meshes["obj"]),
                                              ex.render_asset(host))
                cpu_s = time.perf_counter() - t0
                del host
            self.check(same and max(errs.values()) <= IO_TOL["pass"],
                       f"OBJ import rendered at {RENDER_RES}² card vs CPU "
                       f"(the CPU's import and render in {cpu_s:.1f} s): "
                       f"face_idx {'equal' if same else 'DIFFERS'}; passes "
                       + ", ".join(f"{k} {v:.2e}" for k, v in
                                   sorted(errs.items()))
                       + f" of max|x| (<= {IO_TOL['pass']:g})")
            t0 = time.perf_counter()
            gs, n = self.drive(names, lambda: ex.gaussian_scene(d))
            r["gauss_path_s"] = time.perf_counter() - t0
            r["gauss_bytes"] = os.path.getsize(gs["paths"][0])
            moved, back = gs["moved"], gs["reimported"]
            q = moved.orientations
            qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                          keepdim=True),
                                 min=1e-12)
            rel = {k: float(((getattr(back, k) - getattr(moved, k)).abs()
                             / getattr(moved, k).abs()).max())
                   for k in ("orientations", "opacities", "scales")}
            exact = {k: torch.equal(getattr(back, k), getattr(moved, k))
                     for k in ("positions", "sh_coeff")}
            exact["orientations normalized"] = torch.equal(back.orientations,
                                                           qn)
            self.check(all(exact.values())
                       and max(rel.values()) <= IO_TOL["act"]
                       and back.positions.is_cuda and not any(n.values())
                       and moved.sh_coeff.shape[1] == 16,
                       f"{moved.positions.shape[0]} gaussians at SH degree 3 "
                       f"({r['gauss_bytes']} bytes a file) round trip after "
                       f"the transform in {r['gauss_path_s']:.2f} s: bit for "
                       f"bit {exact}; relative " + ", ".join(
                           f"{k} {v:.2e}" for k, v in rel.items())
                       + f" (<= {IO_TOL['act']:g}); launches {n}")
            del gs, moved, back, q, qn
            root = ex.write_shapenet(os.path.join(d, "shapenet"))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                (ds, pts), n = self.drive(names, lambda: ex.dataset(
                    root, os.path.join(d, "pool")))
                r["pool_s"] = time.perf_counter() - t0
            fallback = [str(w.message) for w in caught
                        if "falling back" in str(w.message)]
            t0 = time.perf_counter()
            serial, pts_s = ex.dataset(root, os.path.join(d, "serial"),
                                       num_workers=0)
            r["serial_s"] = time.perf_counter() - t0
            self.check(not fallback and pts.is_cuda and torch.equal(pts,
                                                                    pts_s)
                       and pts.shape == (ex.MODELS, ex.SAMPLES, 3)
                       and not any(n.values()),
                       f"CachedDataset over ShapeNetV2 ({ex.MODELS} models): "
                       f"{ex.WORKERS} spawned workers {r['pool_s']:.2f} s, "
                       f"fallback {fallback}; the serial loop "
                       f"{r['serial_s']:.2f} s; points {tuple(pts.shape)} "
                       f"on {pts.device}, pool = serial "
                       f"{torch.equal(pts, pts_s)}; launches {n}")
            step, *_ = ex.graph_conv(meshes["obj"])
            loss, n = self.drive(names, step)
            self.check(bool(torch.isfinite(loss)) and not any(n.values()),
                       f"GraphConv {ex.GCN_WIDTHS} at B = {ex.GCN_BATCH} on "
                       f"the asset's {meshes['obj'].vertices.shape[0]} "
                       f"vertices, forward and backward: loss "
                       f"{float(loss):.6g}; launches {n}")
        from kaolin_tpu_torch.ops import random as krandom
        from kaolin_tpu_torch.ops.gcn import GraphConv
        from kaolin_tpu_torch.utils import testing as ktesting
        made = {"GraphConv": GraphConv(3, 4).w.device,
                "ops.random.manual_seed": krandom.manual_seed(0).device,
                "utils.testing.seed_everything":
                    ktesting.seed_everything(0).device}
        self.check(all(v.type == "cuda" for v in made.values()),
                   f"made on the card by default: {made}")
        mod = load_example("torch_tutorial_working_with_meshes")
        _, n = self.drive(names, lambda: mod.main("cuda"))
        self.check(not any(n.values()), "torch_tutorial_working_with_meshes "
                   f"at full size passed its checks; launches {n}")

    def gcn_bound(self, mesh, widths, batch, nnz):
        """GraphConv's forward and backward: per layer the two products
        (adjacency side and self layer) of 2·B·N·in·out operations each,
        the sparse product's 2·B·nnz·out forward and again backward, the
        weight gradients' products and the input gradients' (not the first
        layer's, whose features need none) → (bytes of the inputs read
        and the gradients written, operations)."""
        n = mesh.vertices.shape[0]
        ops = 0
        weights = 0
        for i, (di, do) in enumerate(zip(widths[:-1], widths[1:])):
            mm = 2 * batch * n * di * do
            sp = 2 * batch * nnz * do
            ops += 2 * mm + sp                        # forward
            ops += 2 * mm + (2 * mm if i else 0) + sp  # backward
            weights += 2 * (di * do + do)
        nbytes = 4 * (batch * n * widths[0] + 2 * weights) + 12 * nnz
        return nbytes, ops

    def phase_io_timing(self):
        """The asset path's times on the card: each format's import on the
        host clock, synced (median of 3), file bytes;
        the 512² render of the OBJ and GLB imports (CUDA events, median of
        10; device busy, idle share, largest ops, #1's share; peak); the
        2^20-gaussian export and import (host clock) and transform (CUDA
        events, median of 10; peak); GraphConv's forward and backward
        (CUDA events, median of 10; peak; bound); the dataset's pool
        against its serial loop (measured in phase_io_path)."""
        import tempfile

        torch, ex, r = self.torch, self.asset_ex, self.io
        self.check_precision("phase_io_timing")
        with tempfile.TemporaryDirectory() as d:
            paths, a = ex.write_asset(d)
            meshes = {}
            for fmt, path in paths.items():
                kw = dict(with_materials=True, raw_materials=False) \
                    if fmt == "obj" else {}
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    meshes[fmt] = self.kio.import_mesh(path, **kw)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                tex = a["checker"].shape[0]
                maps = {"obj": f", 2 PNG maps of {tex}²",
                        "glb": f", 4 embedded PNGs of {tex}²"}
                print(f"import {fmt.upper()} ({os.path.getsize(path)} bytes"
                      f"{maps.get(fmt, '')}; {a['faces'].shape[0]} faces): "
                      f"{statistics.median(times):.4f} s host wall synced "
                      f"(median of 3) [{self.card}]", flush=True)
            with torch.no_grad():
                for fmt in ("obj", "glb"):
                    mesh = meshes[fmt]
                    fn = lambda: ex.render_asset(mesh)  # noqa: E731
                    ms = statistics.median(self.time_ms(fn, IO_TIMED))
                    peak = self.peak_mib(fn)
                    busy, kms = self.profile_path(
                        f"render of the {fmt.upper()} import at "
                        f"{RENDER_RES}²", ("winner",), fn, record=False)
                    print(f"render of the {fmt.upper()} import at "
                          f"{RENDER_RES}²: {ms:.4f} ms (CUDA events, median "
                          f"of {IO_TIMED}); #1 {kms['winner']:.4f} device ms"
                          f", {kms['winner'] / busy:.4f} of busy; peak "
                          f"{peak:.1f} MiB [{self.card}]", flush=True)
            g = ex._random_gaussians(ex.GAUSSIANS)
            path = os.path.join(d, "g.ply")
            t0 = time.perf_counter()
            self.kio.ply.export_gaussiancloud(
                path, g["positions"], g["orientations"], g["scales"],
                g["opacities"], g["sh_coeff"])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            model = self.kio.import_gaussiancloud(path)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            transform = torch.as_tensor(ex.gs_transform(), device="cuda")

            def fn():
                return ex.transform_gaussians(
                    model.positions, model.orientations, model.scales,
                    transform, sh_coeff=model.sh_coeff)

            ms = statistics.median(self.time_ms(fn, IO_TIMED))
            peak = self.peak_mib(fn)
            print(f"{ex.GAUSSIANS} gaussians at SH degree 3 "
                  f"({os.path.getsize(path)} bytes): export {t1 - t0:.4f} s "
                  f"(from host arrays), import to the card {t3 - t2:.4f} s "
                  f"(host wall synced); transform_gaussians with the SH "
                  f"rotation {ms:.4f} ms (CUDA events, median of "
                  f"{IO_TIMED}), peak {peak:.1f} MiB [{self.card}]",
                  flush=True)
            del model, g
        mesh = meshes["obj"]
        step, _, _, adj = ex.graph_conv(mesh)
        fwd_layers = ex.graph_conv(mesh)[1]
        fwd = lambda: self.gcn_forward(mesh, fwd_layers)  # noqa: E731
        f_ms = statistics.median(self.time_ms(fwd, IO_TIMED))
        s_ms = statistics.median(self.time_ms(step, IO_TIMED))
        peak = self.peak_mib(step)
        busy, _ = self.profile_path(
            f"GraphConv {ex.GCN_WIDTHS} forward and backward", (), step,
            record=False)
        nbytes, ops = self.gcn_bound(mesh, ex.GCN_WIDTHS, ex.GCN_BATCH,
                                     adj[1].shape[0])
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        bound = max(t_bytes, t_ops)
        print(f"GraphConv {ex.GCN_WIDTHS} at B = {ex.GCN_BATCH} on "
              f"{mesh.vertices.shape[0]} vertices, {adj[1].shape[0]} edges: "
              f"forward {f_ms:.4f} ms, forward and backward {s_ms:.4f} ms "
              f"(CUDA events, median of {IO_TIMED}), device busy "
              f"{busy:.4f} ms a step, peak {peak:.1f} MiB; bound {nbytes} "
              f"bytes -> {t_bytes:.6f} ms, {ops / 1e9:.2f} G operations -> "
              f"{t_ops:.6f} ms; {bound:.6f} ms by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}, share "
              f"{bound / s_ms:.4f} [{self.card}]", flush=True)
        print(f"CachedDataset preprocessing of {ex.MODELS} models "
              f"({ex.SAMPLES} samples each): {ex.WORKERS} spawned workers "
              f"{r['pool_s']:.4f} s, the serial loop {r['serial_s']:.4f} s "
              f"(host wall, phase_io_path) [{self.card}]", flush=True)

    # -- the asset through USD, the native library, the visualizers -------
    @contextlib.contextmanager
    def native_calls(self, label):
        """Inside, the Crate reader's LZ4 blocks are counted as it asks for
        them; after, every one of them and every ``expect_check_sign``
        native ``check_sign`` must have reached the library → the dict
        that the caller sets ``expect_check_sign`` in."""
        crate, calls = self.usd_crate, self.native.calls
        before, block, seen = dict(calls), crate._lz4_block, {
            "blocks": 0, "expect_check_sign": 0}

        def counted(data, size):
            seen["blocks"] += 1
            return block(data, size)

        crate._lz4_block = counted
        try:
            yield seen
        finally:
            crate._lz4_block = block
        hit = {k: calls[k] - before[k] for k in calls}
        self.check(seen["blocks"] > 0
                   and hit["lz4_decompress_block"] == seen["blocks"]
                   and hit["check_sign_cpu"] == seen["expect_check_sign"],
                   f"{label}: every native call reached the library built "
                   f"from the port's source: {seen['blocks']} LZ4 blocks "
                   f"asked, {hit['lz4_decompress_block']} decoded there; "
                   f"{seen['expect_check_sign']} native check_sign asked, "
                   f"{hit['check_sign_cpu']} there")

    def usd_mesh_errs(self, got, a, ext):
        """How far an imported asset is from the arrays written: the
        geometry, the assignments and the materials' values and maps (at 8
        bits, as the PNGs hold them) exactly (0 or 1) for ``.usdc``; the
        ``.usda``'s floats as max|x − y| / max|y|."""
        torch, ex = self.torch, self.usd_ex
        exact = ext == "usdc"

        def diff(x, want, exact=True):
            x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            want = np.asarray(want)
            if x.shape != want.shape:
                return float("inf")
            if exact:
                return float(not np.array_equal(x, want))
            return float(np.abs(x - want).max()) / float(np.abs(want).max())

        mesh, _ = got
        errs = {k: diff(mesh.get_attribute(k), a[k], exact or k in (
            "faces", "face_uvs_idx", "material_assignments"))
            for k in ("vertices", "faces", "uvs", "face_uvs_idx",
                      "material_assignments")}
        for i, want in enumerate(ex.materials(a)):
            have = mesh.materials[i]
            for k in want.get_attributes(only_tensors=True):
                w = getattr(want, k).numpy()
                if k.endswith("_texture"):   # HWC written, CHW read
                    w = (self.asset_ex._to8(w).astype(np.float32)
                         / 255.0).transpose(2, 0, 1)
                errs[f"material{i}.{k}"] = diff(getattr(have, k), w,
                                                exact or k.endswith(
                                                    "_texture"))
        return errs

    def usd_cameras(self, cam, ref):
        """How far a camera is from ``ref``: the view matrix's and the
        intrinsics' max|x − y| / max(max|y|, 1), the larger."""
        return max(float((x.cpu() - y.cpu()).abs().max())
                   / max(float(y.abs().max()), 1.0)
                   for x, y in ((cam.view_matrix(), ref.view_matrix()),
                                (cam.intrinsics.params,
                                 ref.intrinsics.params)))

    def cpu_turntable(self, res):
        """A CPU visualizer whose render draws nothing: its cameras after
        the example's events are the card's reference."""
        from kaolin_tpu_torch.render.easy_render import default_camera
        from kaolin_tpu_torch.visualize import IpyTurntableVisualizer
        blank = np.zeros((res, res, 3), np.uint8)
        viz = IpyTurntableVisualizer(res, res, default_camera(res, "cpu"),
                                     lambda camera: {"img": blank})
        return self.usd_ex.drive(viz)

    def phase_usd_parity(self):
        """The native library built from the port's source; the USD path's
        pieces on the card against the port's CPU on a small copy of the
        asset (24 x 32 sphere, 64² maps): the ``.usda`` and ``.usdc`` files
        written from CUDA tensors byte-equal to those from CPU tensors
        (textures too), their imports equal, rendered at 64² with face_idx
        equal and every pass within 1e-5 of its max|x|; the native
        ``check_sign`` on the card's tensors of the training path's torus
        (4,096 faces, 100,000 candidates) against the device's ray parity
        (equal but within 1e-5 of an edge or face) and equal to the native
        answer on the CPU's tensors."""
        import filecmp
        import tempfile

        torch, ex, p, nb = self.torch, self.usd_ex, USD_PARITY, \
            self.native_build
        so = nb.library_path()
        print("native library:", " ".join(nb.command(so)), flush=True)
        t0 = time.perf_counter()
        ok = self.native.is_available()
        self.check(ok, f"the native library built by g++ "
                   f"({nb.compiler_version()}) from "
                   f"{os.path.relpath(nb.SOURCE, ROOT)} into "
                   f"{os.path.relpath(so, ROOT)} and loaded in "
                   f"{time.perf_counter() - t0:.1f} s; "
                   f"{self.native.load_error()}")
        with tempfile.TemporaryDirectory() as d, \
                self.native_calls("phase_usd_parity") as seen:
            a = ex.asset_arrays(p["asset"], p["tex"])
            files, meshes = {}, {}
            for dev in ("cuda", "cpu"):
                on = {k: torch.as_tensor(v, device=dev) for k, v in a.items()}
                for ext in ("usda", "usdc"):
                    files[dev, ext] = ex.write_usd(
                        os.path.join(d, dev, ext, f"asset.{ext}"), on)
                    meshes[dev, ext] = ex.import_usd(files[dev, ext], dev)[0]
            for ext in ("usda", "usdc"):
                cmp = filecmp.dircmp(os.path.join(d, "cuda", ext, "textures"),
                                     os.path.join(d, "cpu", ext, "textures"))
                textures = sorted(cmp.common_files)
                same = filecmp.cmp(files["cuda", ext], files["cpu", ext],
                                   shallow=False) and not cmp.diff_files \
                    and not cmp.left_only and not cmp.right_only
                card, cpu = meshes["cuda", ext], meshes["cpu", ext]
                equal = all(torch.equal(card.get_attribute(k).cpu(),
                                        cpu.get_attribute(k))
                            for k in ("vertices", "faces", "uvs",
                                      "face_uvs_idx", "material_assignments"))
                equal &= all(torch.equal(getattr(mc, k).cpu(), getattr(mh, k))
                             for mc, mh in zip(card.materials, cpu.materials)
                             for k in mh.get_attributes(only_tensors=True))
                with torch.no_grad():
                    same_ids, errs = self.render_errs(
                        ex.render(card, p["res"]), ex.render(cpu, p["res"]))
                self.check(same and equal and same_ids
                           and max(errs.values()) <= USD_TOL["pass"]
                           and card.vertices.is_cuda,
                           f".{ext} of the {p['asset']} asset written from "
                           f"CUDA and from CPU tensors: the files and "
                           f"textures {textures} byte-equal {same}; the "
                           f"imports equal {equal}; rendered at "
                           f"{p['res']}²: face_idx "
                           f"{'equal' if same_ids else 'DIFFERS'}; passes "
                           + ", ".join(f"{k} {v:.2e}" for k, v in
                                       sorted(errs.items()))
                           + f" of max|x| (<= {USD_TOL['pass']:g})")
            verts, faces, cand = self.torus_candidates("cuda")
            answers = {}
            for dev in ("cuda", "cpu"):
                native, plain = ex.native_check_sign(dev)
                answers[dev] = (native.cpu(), plain.cpu(), native.device)
                seen["expect_check_sign"] += 1
            native, plain, where = answers["cuda"]
            differ = torch.nonzero(native != plain)[:, 0].numpy()
            margins = check_sign_margin(verts.cpu().numpy(),
                                        faces.cpu().numpy(),
                                        cand.cpu().numpy()[differ])
            self.check(all(m <= CHECK_SIGN_MARGIN for m in margins)
                       and torch.equal(native, answers["cpu"][0])
                       and where.type == "cuda",
                       f"check_sign(backend='native') of the torus "
                       f"({faces.shape[0]} faces) and {cand.shape[0]} "
                       f"candidates on the card's tensors (answer on "
                       f"{where}) against the device's ray parity: "
                       f"{len(differ)} differ, at margins "
                       f"{[float(f'{m:.2e}') for m in margins]} (each within "
                       f"{CHECK_SIGN_MARGIN:g} of an edge or face); equal to "
                       f"the native answer on the CPU's tensors "
                       f"{torch.equal(native, answers['cpu'][0])}; "
                       f"{int(native.sum())} inside")

    def relog(self, logdir, fit, device):
        """The fit's checkpoints logged again into ``logdir`` from tensors
        on ``device`` → the seconds the Timelapse took."""
        ex, vis = self.usd_ex, self.visualize
        timelapse = vis.Timelapse(logdir)
        faces = fit["faces"].to(device)
        t0 = time.perf_counter()
        for i, (v, pts) in enumerate(zip(fit["vertices"], fit["points"])):
            timelapse.add_mesh_batch(iteration=i * ex.LOG_EVERY,
                                     category="fit",
                                     vertices_list=[v.to(device)],
                                     faces_list=[faces])
            timelapse.add_pointcloud_batch(iteration=i * ex.LOG_EVERY,
                                           category="samples",
                                           pointcloud_list=[pts.to(device)])
        return time.perf_counter() - t0

    def phase_usd_path(self):
        """The USD path at full size on the card, each piece with every
        launch counter set to 0 before and read after: the 81,408-face
        asset with its 1,024² maps written as ``.usda`` and ``.usdc`` and
        imported (no launch; the ``.usdc`` import bit for bit, the
        ``.usda`` within 5e-6 relative; the dispatcher's mesh equal to
        ``io.usd.import_mesh``'s); the ``.usdc`` import rendered at 512²
        (#1 once, #7's forward once a texture map of its materials, no other
        kernel; #1's winner ids against its plain version on the same CUDA
        tensors; face_idx equal to the OBJ import's render of the same
        geometry); 2^20 gaussians through a ``.usdc`` bit for bit; the
        100-step fit logged by ``Timelapse`` every 10 steps (#1 once a
        render and a step, #7's forward once a texture map a render and a
        step and its backward once a map a step; 11 checkpoints; the last
        within 5e-6 relative of the fit's vertices; the files and dash3d's
        wire bytes from the card's tensors equal to those from CPU copies);
        the turntable's 16 renders (#1 16 times, #7's forward once a map a
        render; a frame's winner ids against the plain version; its cameras
        within 1e-6 of a CPU visualizer's after the same events)."""
        import filecmp
        import tempfile

        torch, ex, r = self.torch, self.usd_ex, self.usd
        names = list(self.counters())
        others = [k for k in names
                  if k not in ("winner", *TEXTURE_KERNELS, *REGATHER_KERNELS)]
        with tempfile.TemporaryDirectory() as d, \
                self.native_calls("phase_usd_path"):
            a = ex.asset_arrays()
            t0 = time.perf_counter()
            paths = {ext: ex.write_usd(os.path.join(d, ext, f"asset.{ext}"),
                                       a) for ext in ("usda", "usdc")}
            r["write_s"] = time.perf_counter() - t0
            r["bytes"] = {ext: os.path.getsize(p) for ext, p in paths.items()}
            got, n = self.drive(names, lambda: {
                ext: ex.import_usd(p) for ext, p in paths.items()})
            errs = {ext: self.usd_mesh_errs(got[ext], a, ext)
                    for ext in got}
            want_t = np.asarray(ex.TRANSFORM, np.float32)
            terr = {ext: float((got[ext][1].cpu() - torch.from_numpy(
                want_t)).abs().max()) for ext in got}
            self.check(max(errs["usdc"].values()) == 0.0
                       and max(errs["usda"].values()) <= USD_TOL["usda"]
                       and max(terr.values()) <= USD_TOL["usda"]
                       and got["usdc"][0].vertices.is_cuda
                       and not any(n.values()),
                       f"the {a['faces'].shape[0]}-face asset written as "
                       f".usda and .usdc in {r['write_s']:.2f} s "
                       f"({r['bytes']} bytes) and imported on the card: "
                       ".usdc " + ", ".join(f"{k} {v:g}" for k, v in
                                            errs["usdc"].items())
                       + " (0: bit for bit); .usda " + ", ".join(
                           f"{k} {v:.2e}" for k, v in errs["usda"].items())
                       + f" (<= {USD_TOL['usda']:g}); transforms {terr}; "
                       f"launches {n}")
            for ext, path in paths.items():
                via = self.kio.import_mesh(path)
                direct = self.usd_io.import_mesh(path)
                same = all(torch.equal(via.get_attribute(k),
                                       direct.get_attribute(k))
                           for k in ("vertices", "faces", "uvs",
                                     "face_uvs_idx"))
                self.check(same, f"io.import_mesh of the .{ext} equals "
                           f"io.usd.import_mesh's: {same}")
            mesh = got["usdc"][0]
            with torch.no_grad():
                passes, n = self.drive(names, lambda: ex.render(mesh))
                covered = int((passes["face_idx"] >= 0).sum())
                finite = all(bool(torch.isfinite(v.float()).all())
                             for v in passes.values())
                maps = self.maps_sampled(mesh)
                self.check(finite and covered > 0 and n["winner"] == 1
                           and not any(n[k] for k in others)
                           and self.texture_launches(n, maps),
                           f".usdc import rendered at {RENDER_RES}²: "
                           f"{len(passes)} passes, {covered} covered "
                           f"pixels, finite; launches {n} ({maps} texture "
                           "maps)")
                self.check_winner_at(f"the .usdc import at {RENDER_RES}²",
                                     lambda: ex.render(mesh))
                obj = self.kio.import_mesh(
                    self.asset_ex._write_obj(d, a), with_materials=True,
                    raw_materials=False)
                same = torch.equal(passes["face_idx"],
                                   ex.render(obj)["face_idx"])
                self.check(same, f".usdc import's {RENDER_RES}² render "
                           "against the OBJ import's of the same geometry: "
                           f"face_idx {'equal' if same else 'DIFFERS'}")
                del obj
            t0 = time.perf_counter()
            (g, back, gpath), n = self.drive(
                names, lambda: ex.gaussian_round_trip(d))
            r["gauss_s"] = time.perf_counter() - t0
            r["gauss_bytes"] = os.path.getsize(gpath)
            wxyz = g["orientations"]
            exact = {k: np.array_equal(getattr(back, k).cpu().numpy(), want)
                     for k, want in (("positions", g["positions"]),
                                     ("orientations", wxyz),
                                     ("scales", g["scales"]),
                                     ("opacities", g["opacities"]),
                                     ("sh_coeff", g["sh_coeff"]))}
            self.check(all(exact.values()) and back.positions.is_cuda
                       and not any(n.values()),
                       f"{g['positions'].shape[0]} gaussians at SH degree 3 "
                       f"through a .usdc ({r['gauss_bytes']} bytes) and "
                       f"back to the card in {r['gauss_s']:.2f} s: bit for "
                       f"bit {exact}; launches {n}")
            del g, back
        # the fit is torch_easy_render.py's, on its scene
        fit_maps = self.maps_sampled(self.render_ex.scene("cuda"))
        with tempfile.TemporaryDirectory() as d:
            logdir = os.path.join(d, "card")
            t0 = time.perf_counter()
            fit, n = self.drive(names, lambda: ex.log_fit(logdir))
            r["fit_s"] = time.perf_counter() - t0
            r["fit"] = fit
            parser = self.visualize.TimelapseParser(logdir)
            times = parser.dir_info["mesh"]["fit"][0]["times"]
            last = self.usd_io.import_mesh(
                parser.get_file_path("mesh", "fit", 0), time=times[-1],
                device="cpu").vertices
            want = fit["vertices"][-1].cpu()
            lerr = float((last - want).abs().max() / want.abs().max())
            self.relog(os.path.join(d, "host"), fit, "cpu")
            files = sorted(os.path.relpath(os.path.join(root, f), logdir)
                           for root, _, fs in os.walk(logdir) for f in fs)
            _, mismatch, errors = filecmp.cmpfiles(
                logdir, os.path.join(d, "host"), files, shallow=False)
            wire = {k: ex.wire_bytes(os.path.join(d, k))
                    for k in ("card", "host")}
            self.check(n["winner"] == ex.FIT_STEPS + 1
                       and not any(n[k] for k in others)
                       and self.texture_launches(
                           n, fit_maps * (ex.FIT_STEPS + 1),
                           fit_maps * ex.FIT_STEPS)
                       and times == [float(t) for t in range(
                           0, ex.FIT_STEPS + 1, ex.LOG_EVERY)]
                       and parser.num_mesh_items() == 1
                       and parser.num_pointcloud_items() == 1
                       and lerr <= USD_TOL["usda"] and not mismatch
                       and not errors and wire["card"] == wire["host"]
                       and None not in wire["card"]
                       and fit["losses"][-1] < fit["losses"][0],
                       f"the fit's {ex.FIT_STEPS} steps logged by Timelapse "
                       f"in {r['fit_s']:.2f} s: checkpoints at {times}; the "
                       f"last {lerr:.2e} from the fit's vertices (<= "
                       f"{USD_TOL['usda']:g}); loss {fit['losses'][0]:.5f} "
                       f"-> {fit['losses'][-1]:.5f}; files {files} from the "
                       f"card's tensors byte-equal to those from CPU copies "
                       f"{not mismatch and not errors}; dash3d's wire bytes "
                       f"({len(wire['card'][1])} + {len(wire['card'][2])}) "
                       f"equal {wire['card'] == wire['host']}; launches {n} "
                       f"({fit_maps} texture maps)")
        viz = ex.turntable(mesh)
        _, n = self.drive(names, lambda: ex.drive(viz))
        cam_err = self.usd_cameras(viz.camera,
                                   self.cpu_turntable(RENDER_RES).camera)
        self.check(n["winner"] == ex.RENDERS and not any(n[k] for k in others)
                   and self.texture_launches(n, maps * ex.RENDERS)
                   and viz.canvas.last_image.shape == (RENDER_RES,
                                                       RENDER_RES, 3)
                   and cam_err <= USD_TOL["camera"],
                   f"the turntable at {RENDER_RES}² on the .usdc import: "
                   f"{len(ex.EVENTS)} events, launches {n}; its camera "
                   f"{cam_err:.2e} of max|x| from a CPU visualizer's after "
                   f"the same events (<= {USD_TOL['camera']:g})")
        self.check_winner_at("a turntable frame at "
                             f"{RENDER_RES}²", lambda: viz.render(viz.camera))
        r["mesh"], r["viz"] = mesh, viz

    def usd_split(self, fn):
        """``fn`` (an import) once, its host wall synced, split by wrapping
        what it calls: the layer read (the file, or the Crate reader and
        its text), the prim scan, the PNG maps' decode and the moves to
        tensors on the device (synced) → (seconds, {part: seconds})."""
        torch, core, kio = self.torch, self.usd_core, self.kio
        spent = {"read": 0.0, "scan": 0.0, "maps": 0.0, "to tensors": 0.0}
        where = {"read": (core, "_read_usd_text"),
                 "scan": (core, "_scan_prims"),
                 "maps": (kio.utils, "read_image"),
                 "to tensors": (core, "_on_device")}
        kept = {k: getattr(mod, name) for k, (mod, name) in where.items()}

        def timed(key, f):
            def g(*args, **kwargs):
                t0 = time.perf_counter()
                out = f(*args, **kwargs)
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t0
                return out
            return g

        for k, (mod, name) in where.items():
            setattr(mod, name, timed(k, kept[k]))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            for k, (mod, name) in where.items():
                setattr(mod, name, kept[k])
        return total, spent

    def phase_usd_timing(self):
        """The USD path's times on the card: each import (host wall synced,
        median of 3) split into the layer read, the prim scan, the maps'
        decode, the moves to tensors and the rest (the attributes' text to
        arrays); the ``.usdc`` import's 512² render (CUDA events, median of
        10; device ops, busy, idle share, #1's ms; peak); the 11-checkpoint
        Timelapse of the fit; a turntable frame (CUDA events, median of
        10, the copy of its image to the host included); the native
        ``check_sign`` of the torus's 100,000 candidates against the
        device's (host wall synced, median of 3)."""
        import tempfile

        torch, ex, r = self.torch, self.usd_ex, self.usd
        with tempfile.TemporaryDirectory() as d:
            a = ex.asset_arrays()
            for ext in ("usda", "usdc"):
                path = ex.write_usd(os.path.join(d, ext, f"asset.{ext}"), a)
                runs = sorted((self.usd_split(lambda: ex.import_usd(path))
                               for _ in range(3)), key=lambda x: x[0])
                total, parts = runs[1]
                rest = total - sum(parts.values())
                print(f"import .{ext} ({os.path.getsize(path)} bytes, "
                      f"{a['faces'].shape[0]} faces, 2 PNG maps of "
                      f"{ex.TEX}²): {total:.4f} s host wall synced (median "
                      "of 3): " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                            parts.items())
                      + f", the rest (text to arrays) {rest:.4f} s "
                      f"[{self.card}]", flush=True)
        mesh, viz = r["mesh"], r["viz"]
        with torch.no_grad():
            fn = lambda: ex.render(mesh)  # noqa: E731
            ms = statistics.median(self.time_ms(fn, USD_TIMED))
            peak = self.peak_mib(fn)
            busy, kms = self.profile_path(
                f"render of the .usdc import at {RENDER_RES}²", ("winner",),
                fn, record=False)
            print(f"render of the .usdc import at {RENDER_RES}²: {ms:.4f} "
                  f"ms (CUDA events, median of {USD_TIMED}); #1 "
                  f"{kms['winner']:.4f} device ms, "
                  f"{kms['winner'] / busy:.4f} of busy; peak {peak:.1f} MiB "
                  f"[{self.card}]", flush=True)
            frame = statistics.median(self.time_ms(viz.render_update,
                                                   USD_TIMED))
        with tempfile.TemporaryDirectory() as d:
            logged = self.relog(d, r["fit"], "cuda")
        print(f"Timelapse of the fit: {len(r['fit']['vertices'])} checkpoints "
              f"of {r['fit']['faces'].shape[0]} faces and {ex.CLOUD} points "
              f"written in {logged:.4f} s from the card's tensors (host "
              f"wall); the fit with its logging {r['fit_s']:.4f} s "
              f"(phase_usd_path); a turntable frame at {RENDER_RES}² "
              f"{frame:.4f} ms (CUDA events, median of {USD_TIMED}, the "
              f"image's copy to the host included) [{self.card}]",
              flush=True)
        from kaolin_tpu_torch.ops.mesh import check_sign
        verts, faces, cand = self.torus_candidates("cuda")
        times = {}
        for key in ("native", None):
            fn = lambda: check_sign(verts[None], faces, cand[None],  # noqa
                                    backend=key)
            times[key] = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
        print(f"check_sign of the torus ({faces.shape[0]} faces) and "
              f"{cand.shape[0]} candidates on the card's tensors: native "
              f"(host C++, the copies to and from the host included) "
              f"{statistics.median(times['native']):.4f} s, the device's "
              f"ray parity {statistics.median(times[None]):.4f} s (host "
              f"wall synced, median of 3) [{self.card}]", flush=True)

    # -- the table gather and the probe path ------------------------------
    def gather_case(self, n_tab, shape, lo=0, seed=0):
        """A random table of ``n_tab`` floats and int32 indices of ``shape``
        drawn from ``[lo, n_tab)``, on the card."""
        rng = np.random.RandomState(seed)
        table = rng.randn(n_tab).astype(np.float32)
        idx = rng.randint(lo, n_tab, shape).astype(np.int32)
        return self.from_numpy_tree((table, idx), self.device)

    def phase_gather_parity(self):
        torch, cg = self.torch, self.cg
        big = 1 << 20
        cases = [
            (f"probe shape {GATHER_IDX}, 2^20 table",
             self.gather_case(big, GATHER_IDX)),
            (f"{GATHER_IDX}, 2^14 table", self.gather_case(1 << 14,
                                                           GATHER_IDX)),
            (f"{cg.SMEM_MAX_FLOATS:,} floats, 2^20 indices",
             self.gather_case(cg.SMEM_MAX_FLOATS, (big,), seed=1)),
            (f"{cg.SMEM_MAX_FLOATS + 1:,} floats, 2^20 indices",
             self.gather_case(cg.SMEM_MAX_FLOATS + 1, (big,), seed=2)),
            ("2^14 table, indices in [-2^15, 2^14) and past the end",
             self.gather_case(1 << 14, (big,), lo=-(1 << 15), seed=3)),
            ("2^20 table, 1,000,003 indices, negative ones too",
             self.gather_case(big, (1_000_003,), lo=-big, seed=4)),
            (f"{cg.SMEM_MAX_FLOATS:,} floats, 3 indices", self.gather_case(
                cg.SMEM_MAX_FLOATS, (3,), lo=-100, seed=5)),
            ("2^20 table, 2^22 indices (many tiles a block)",
             self.gather_case(big, (1 << 22,), seed=7)),
            ("2^20 table, 4,097 indices (4 tiles and 1, no prefetch)",
             self.gather_case(big, (4097,), lo=-big, seed=8)),
            ("2^24 table (64 MB, more than L2), 2^20 indices",
             self.gather_case(1 << 24, (big,), seed=9)),
            ("2^18 table, 616,447 indices (601 tiles and 1,023)",
             self.gather_case(1 << 18, (601 * 1024 + 1023,), lo=-(1 << 18),
                              seed=10)),
        ]
        table, idx = self.gather_case(1 << 14, (4099,), lo=-(1 << 14), seed=6)
        cases.append(("unaligned views, 2^14 - 1 floats, 4,098 indices",
                      (table[1:], idx[1:])))
        cases += self.smem_edge_cases()
        for label, (table, idx) in cases:
            if "past the end" in label:
                idx = torch.where(idx % 7 == 0, idx + (3 << 14), idx)
            want = cg.table_gather_plain(table, idx)
            route = cg.gather_route(table.shape[0])
            fns = {"table_gather_l2": cg.table_gather_l2_cuda}
            if table.shape[0] <= cg.SMEM_MAX_FLOATS:
                fns["table_gather_smem"] = cg.table_gather_smem_cuda
            for name, fn in fns.items():
                got = fn(table, idx)
                same = bool(torch.equal(got.view(torch.int32),
                                        want.view(torch.int32)))
                self.check(same and got.shape == idx.shape,
                           f"{name} vs plain [{label}]: bitwise {same}")
                self.record_err(name, float((got - want).abs().max()))
            before = self.launches()
            cg.table_gather(table, idx)
            after = self.launches()
            took = [k for k in self.counters() if after[k] != before[k]]
            self.check(took == [f"table_gather_{route}"],
                       f"table_gather of {table.shape[0]} floats took "
                       f"{took}, the rule says {route}")
        torch.cuda.synchronize()

    def smem_edge_cases(self):
        """The shared-memory route's edges → [(label, (table, idx))]:
        tables of 1, 3, 4, 5 and 1,021 floats and the route's largest, 1
        and 3 indices, fewer indices than one cluster has threads, 4,099
        indices on a grid rounded up to whole clusters (a block gets no
        index), negative and past-the-end indices. Prints each launch as
        ``csrc/gather.cu`` computes it (``cuda_gather.smem_grid``)."""
        cg, big = self.cg, 1 << 20
        top = cg.SMEM_MAX_FLOATS
        cluster, _, threads = cg.smem_grid(1 << 14, 1, self.device)
        few, rounded = cluster * threads - 5, 4099
        cases = [
            ("1 float, 3 indices", self.gather_case(1, (3,), lo=-1,
                                                    seed=20)),
            ("3 floats, 1 index", self.gather_case(3, (1,), lo=-3, seed=21)),
            ("4 floats, 5 indices", self.gather_case(4, (5,), lo=-4,
                                                     seed=22)),
            ("5 floats, 4,099 indices", self.gather_case(5, (4099,), lo=-5,
                                                         seed=23)),
            (f"1,021 floats (no multiple of {cluster} x 4), 2^20 indices",
             self.gather_case(1021, (big,), lo=-1021, seed=24)),
            (f"{top:,} floats (the route's largest), 4,099 indices",
             self.gather_case(top, (4099,), lo=-top, seed=25)),
            (f"2^14 table, {few:,} indices (fewer than a cluster's "
             f"{cluster * threads:,} threads)",
             self.gather_case(1 << 14, (few,), lo=-(1 << 14), seed=26)),
            (f"2^14 table, {rounded:,} indices (a grid rounded up to whole "
             "clusters)",
             self.gather_case(1 << 14, (rounded,), lo=-(1 << 14), seed=27)),
        ]
        out = []
        for label, (table, idx) in cases:
            idx = self.torch.where(idx % 7 == 0, idx + 3 * table.shape[0],
                                   idx)
            c, blocks, _ = cg.smem_grid(table.shape[0], idx.numel(),
                                        table.device)
            # a block's threads take consecutive groups of 4 indices
            busy = min(blocks, -(-(-(-idx.numel() // 4)) // threads))
            print(f"shared-memory route [{label}, past-the-end every 7th]:"
                  f" clusters of {c}, {blocks} blocks launched, {busy} with "
                  f"indices", flush=True)
            if "rounded up" in label:
                self.check(blocks % c == 0 and busy < blocks,
                           f"{label}: {blocks - busy} of {blocks} blocks get "
                           "no index")
            out.append((f"{label}, past the end", (table, idx)))
        return out

    def phase_camera_defaults(self):
        """The camera API without ``device`` builds on the card:
        ``Camera.from_args`` with lists, ``CameraExtrinsics.from_lookat``
        given an eye on the card, the dicts, grids, bases and the legacy
        projection; each equal to its CPU build (``device="cpu"``)."""
        torch = self.torch
        from kaolin_tpu_torch.render import camera as tc
        eye, at, up = [2.0, 1.0, 2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]
        args = dict(eye=eye, at=at, up=up, fov=0.9, width=64, height=48)
        cam, cam_cpu = (tc.Camera.from_args(**args),
                        tc.Camera.from_args(**args, device="cpu"))
        made = {
            "Camera.from_args, lists": (
                (cam.extrinsics.params, cam.intrinsics.params),
                (cam_cpu.extrinsics.params, cam_cpu.intrinsics.params)),
            "CameraExtrinsics.from_lookat, eye on the card": (
                tc.CameraExtrinsics.from_lookat(
                    torch.tensor(eye, device="cuda"), at, up).params,
                tc.CameraExtrinsics.from_lookat(eye, at, up,
                                                device="cpu").params),
            "Camera.from_dict": (
                tc.Camera.from_dict(cam_cpu.to_dict()).extrinsics.params,
                cam_cpu.extrinsics.params),
            "PinholeIntrinsics.from_fov": (
                tc.PinholeIntrinsics.from_fov(64, 48, 0.9).params,
                cam_cpu.intrinsics.params),
            "generate_centered_pixel_coords": (
                tc.generate_centered_pixel_coords(64, 48),
                tc.generate_centered_pixel_coords(64, 48, device="cpu")),
            "blender_coords": (tc.blender_coords(),
                               tc.blender_coords(device="cpu")),
            "generate_perspective_projection": (
                tc.generate_perspective_projection(0.9),
                tc.generate_perspective_projection(0.9, device="cpu")),
        }
        for label, (got, want) in made.items():
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            on_card = all(g.is_cuda for g in got)
            same = all(torch.allclose(g.cpu(), w, rtol=0, atol=1e-6)
                       for g, w in zip(got, want))
            self.check(on_card and same, f"camera without device, {label}: "
                       f"on the card {on_card}, equal to the CPU's within "
                       f"1e-6 {same}")

    # -- the Simplicits sim step ------------------------------------------
    def check_precision(self, label):
        """The sim step's float32 products run in full float32: TF32 off."""
        torch = self.torch
        tf32 = torch.backends.cuda.matmul.allow_tf32
        prec = torch.get_float32_matmul_precision()
        self.check(tf32 is False and prec == "highest",
                   f"{label}: matmul allow_tf32 {tf32}, float32 matmul "
                   f"precision {prec!r}")

    def sim_scene(self, which, device, **kw):
        ex = self.sim_ex
        make = ex.config1_scene if which == "config1" else ex.graft_scene
        return make(device, **kw)

    def phase_sim_parity(self):
        """The card's step against the port's CPU step from the same states:
        the CPU scene's trajectory, each state into the card's step.

        The scene sums its handle norms in float64, so both devices should
        take the same QR pivots, and then the CPU's state goes in as it is.
        Where they do not, a state crosses through the pre-QR basis in
        float64 (z_card = K_card⁻¹ K_cpu z_cpu). The steps are compared by
        their displacements B z, which do not depend on the basis."""
        torch = self.torch
        self.check_precision("phase_sim_parity")
        f64 = torch.float64
        for which, n in SIM_PARITY_STEPS.items():
            cpu = self.sim_scene(which, "cpu")
            states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
            for _ in range(n):
                cpu.run_sim_step()
                states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
            card = self.sim_scene(which, "cuda")
            oc, og = cpu.get_object(0), card.get_object(0)
            same = torch.equal(og.qr_tfm.cpu(), oc.qr_tfm)
            conv = og.qr_tfm_inv.cpu().to(f64) @ oc.qr_tfm.to(f64)
            fn, consts = card.build_functional_step()
            errs = []
            for k in range(n):
                z_in = [(x if same else (conv @ x.to(f64)).float()).cuda()
                        for x in states[k]]
                with torch.no_grad():
                    out = fn(consts, *z_in)
                got = card.sim_B.cpu().to(f64) @ out[0].cpu().to(f64)
                want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
                errs.append(float((got - want).abs().max()
                                  / want.abs().max()))
            raw = [(s.sim_B.cpu().to(f64) @ o.qr_tfm_inv.cpu().to(f64))
                   for s, o in ((card, og), (cpu, oc))]
            b_err = float((raw[0] - raw[1]).abs().max() / raw[1].abs().max())
            self.check(max(errs) <= SIM_Z_TOL and all(
                bool(torch.isfinite(x).all()) for x in states[-1]),
                f"sim step card vs CPU [{which}, D {card.total_dofs}, "
                f"{card.total_qp} points], {n} steps from the CPU's states: "
                f"max |d(B z)| / max|B z| {max(errs):.3e} (per step "
                + ", ".join(f"{e:.1e}" for e in errs)
                + f"); B K K^-1 {b_err:.1e} of max; the same QR pivots "
                f"{same} [{self.card}]")
        self.check_deferred_fallback()

    def check_deferred_fallback(self):
        """The graph's solve: a captured ``_direct_solve`` keeps the
        Cholesky solution and flags a failure; a scene whose graph step
        meets a failed Cholesky runs the step again eagerly."""
        torch, opt = self.torch, self.opt
        rng = torch.Generator().manual_seed(0)
        a = torch.randn(396, 396, generator=rng)
        g = torch.randn(396, generator=rng).cuda()
        flags = []
        for h in ((a @ a.T / 396 + torch.eye(396)).cuda(), (a + a.T).cuda()):
            failed = torch.zeros((), dtype=torch.bool, device="cuda")
            static = h.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), opt.cholesky_only(failed):
                opt._direct_solve(static, g)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), opt.cholesky_only(failed):
                out = opt._direct_solve(static, g)
            failed.zero_()
            graph.replay()
            chol = torch.cholesky_solve(
                g[:, None], torch.linalg.cholesky_ex(h.mT)[0])[:, 0]
            # the Cholesky of an indefinite H is not a solution: not compared
            flags.append((bool(failed),
                          bool(failed) or torch.equal(out, chol)))
        self.check(flags == [(False, True), (True, True)],
                   f"captured solve keeps the Cholesky and flags a failure "
                   f"(SPD, indefinite): {flags}")
        # z = 0.5·N(0, 1): every Cholesky of the step fails (info 50-51)
        z0 = 0.5 * torch.randn(396, generator=torch.Generator().manual_seed(1))
        eager = self.sim_scene("config1", "cuda")
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        for scene in (eager, graph):
            scene.sim_z = z0.to("cuda")
            scene.run_sim_step()
        same = torch.equal(eager.sim_z.view(torch.int32),
                           graph.sim_z.view(torch.int32))
        self.check(graph.graph_steps_rerun == 1 and same,
                   f"graph step where the Cholesky fails: run again eagerly "
                   f"({graph.graph_steps_rerun} step), bit for bit the eager "
                   f"step {same}")

    def fill_freed_memory(self, scene):
        """Tensors of NaN at the sizes of the constants a scene's step holds
        (the 3x3 and D x D identities, the int64 DOF index): if the step's
        graph still read any of them after it was freed, the allocator would
        hand its memory to one of these (fault F14, a graph that read freed
        memory)."""
        torch, d = self.torch, scene.total_dofs
        shapes = ((3, 3),) * 64 + ((d, d),) * 16 + ((2 * d,),) * 64
        return [torch.full(s, float("nan"), device="cuda") for s in shapes]

    def kinematic_scene(self, graphs):
        """Two graft-style objects (64 points, 4 handles; 48 points, 3
        handles), the second kinematic and lifted, with gravity and the
        floor: the scene of ``test_two_objects_one_kinematic_match_jax``."""
        ex = self.sim_ex
        a, b = ex.graft_points(64, 4), ex.graft_points(48, 3)
        b["pts"] = b["pts"] * np.float32(0.5)
        lift = np.eye(4, dtype=np.float32)
        lift[1, 3] = -0.6
        scene = ex.SimplicitsScene(timestep=0.03, max_newton_steps=3,
                                   max_ls_steps=5, device="cuda",
                                   use_cuda_graphs=graphs)
        for p, kin, init in ((a, False, None), (b, True, lift)):
            scene.add_object(ex.SkinnedPhysicsPoints(
                pts=p["pts"], yms=1e4, prs=0.45, rhos=500.0, appx_vol=1.0,
                skinning_weights=p["w"], dwdx=p["dwdx"]),
                is_kinematic=kin, init_transform=init)
        scene.set_scene_gravity((0.0, 9.8, 0.0))
        scene.set_scene_floor(floor_height=-1.0)
        return scene

    def check_kinematic_graph(self):
        """A scene with a kinematic object from the CUDA graph against
        eager: 20 steps, the kinematic object moved by
        ``set_kinematic_object_transform`` after 10, freed memory filled
        after the capture."""
        torch = self.torch
        move = np.eye(4, dtype=np.float32)
        move[0, 3] = 0.2
        scenes = [self.kinematic_scene(graphs) for graphs in (False, True)]
        junk = []
        for k in range(20):
            if k == 10:
                for scene in scenes:
                    scene.set_kinematic_object_transform(1, move)
            for scene in scenes:
                scene.run_sim_step()
            if k == 0:
                junk = self.fill_freed_memory(scenes[1])
        (eager, graph), kin = scenes, scenes[0].obj_z_slices[1]
        err = float((eager.sim_z - graph.sim_z).abs().max()
                    / eager.sim_z.abs().max())
        same = torch.equal(eager.sim_z.view(torch.int32),
                           graph.sim_z.view(torch.int32))
        held = torch.equal(graph.sim_z[kin], graph.get_object(1).z)
        del junk
        self.check(err <= SIM_Z_TOL and graph.graph_steps_rerun == 0
                   and held and bool(torch.isfinite(graph.sim_z).all()),
                   f"kinematic scene (D {graph.total_dofs}, "
                   f"{len(graph.dyn_idx)} dynamic), 20 steps from the graph "
                   f"against eager: max |dz| / max|z| {err:.3e}, bit for "
                   f"bit {same}, {graph.graph_steps_rerun} steps run again "
                   f"eagerly, the kinematic DOFs at the scripted move {held}")

    def phase_sim_path(self):
        """Config 1 in full: 150 steps eager (Newton stops early) and from
        the CUDA graph (fixed trip), mean height read every 30 steps; then
        a scene with a kinematic object, graph against eager."""
        torch, ex = self.torch, self.sim_ex
        self.check_precision("phase_sim_path")
        runs = {}
        for label, graphs in (("eager", False), ("graph", True)):
            scene = self.sim_scene("config1", "cuda", use_cuda_graphs=graphs)
            heights = [ex.mean_height(scene)]

            def path():
                for _ in range(ex.STEPS // 30):
                    scene.run_sim_steps(30)
                    heights.append(ex.mean_height(scene))

            t0 = time.perf_counter()
            _, launches = self.drive((), path)
            wall = time.perf_counter() - t0
            counts = {k: self.driven[k] for k in self.counters()}
            low = float(scene.get_object_deformed_pts(0)[:, 1].min())
            finite = all(bool(torch.isfinite(x).all()) for x in
                         (scene.sim_z, scene.sim_z_dot))
            print(f"config 1, {ex.STEPS} steps, {label}: {wall:.3f} s host "
                  f"wall with the first step's set-up, "
                  f"{scene.graph_steps_rerun} graph steps run again eagerly;"
                  f" mean heights "
                  + ", ".join(f"{h:.4f}" for h in heights)
                  + f"; lowest point {low:.4f}; kernel launches {counts} "
                  f"[{self.card}]", flush=True)
            self.check(finite and scene.current_sim_step == ex.STEPS
                       and heights[-1] < heights[0] - 0.3
                       and min(heights) > -1.0 and low > -1.1
                       and scene.graph_steps_rerun == 0,
                       f"config-1 {label} path: finite, the mean height fell "
                       f"from {heights[0]:.4f} to {heights[-1]:.4f} and "
                       f"stayed above the floor at -1 (lowest mean "
                       f"{min(heights):.4f}, lowest point {low:.4f}), "
                       f"{scene.graph_steps_rerun} steps run again eagerly "
                       f"(config 1 needs no LU)")
            runs[label] = scene
        za, zb = runs["eager"].sim_z, runs["graph"].sim_z
        err = float((za - zb).abs().max() / za.abs().max())
        same = torch.equal(za.view(torch.int32), zb.view(torch.int32))
        self.check(err <= SIM_Z_TOL, f"config-1 graph vs eager after "
                   f"{ex.STEPS} steps: max |dz| / max|z| {err:.3e}, bit for "
                   f"bit {same}")
        self.check_kinematic_graph()

    def phase_sim_timing(self):
        """Steps/s of config 1: eager ``run_sim_step``, one graph replay a
        step, ``run_sim_steps(150)`` eager and from the graph; CUDA-event
        medians. The graph scene is captured after the earlier phases'
        graphs were freed, and the memory their constants would free is
        filled with NaN before it replays (fault F14): its states are held
        against the eager scene's, which took the same steps from the same
        start, and a graph time is reported only from a run in which no
        step ran again eagerly."""
        torch, ex = self.torch, self.sim_ex
        self.check_precision("phase_sim_timing")
        eager = self.sim_scene("config1", "cuda")
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        graph.run_sim_step()       # the capture
        graph.reset_scene()
        junk = self.fill_freed_memory(graph)
        n = SIM_TIMED_STEPS
        before = self.newton.iterations
        e_ms = statistics.median(self.time_ms(eager.run_sim_step, n))
        iters = (self.newton.iterations - before) / (n + 1)
        g_ms = statistics.median(self.time_ms(graph.run_sim_step, n))
        single = (eager.sim_z, graph.sim_z)
        rerun_single = graph.graph_steps_rerun
        eager.reset_scene()
        graph.reset_scene()
        # 4 x 150 steps each from rest: a warm-up call, then 3 timed
        re_ms = statistics.median(self.time_ms(
            lambda: eager.run_sim_steps(ex.STEPS), 3))
        r_ms = statistics.median(self.time_ms(
            lambda: graph.run_sim_steps(ex.STEPS), 3))
        del junk
        rerun = graph.graph_steps_rerun
        errs = [float((a - b).abs().max() / a.abs().max()) for a, b in
                (single, (eager.sim_z, graph.sim_z))]
        same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in (single, (eager.sim_z, graph.sim_z))]
        self.check(max(errs) <= SIM_Z_TOL and rerun == 0,
                   f"config-1 timed graph scene against eager from the same "
                   f"start, after {n + 1} single steps and after "
                   f"{4 * ex.STEPS} steps of run_sim_steps({ex.STEPS}): max "
                   f"|dz| / max|z| {errs[0]:.3e}, {errs[1]:.3e}, bit for bit "
                   f"{same}; {rerun} of the graph's "
                   f"{n + 1 + 4 * ex.STEPS} steps run again eagerly "
                   f"({rerun_single} in the single steps)")
        self.sim.update(iterations=iters, dofs=eager.total_dofs,
                        points=eager.total_qp, newton=eager.max_newton_steps,
                        ls=eager.max_ls_steps)
        if rerun == 0:
            graph_line = (
                f"graph replay {g_ms:.4f} ms ({1e3 / g_ms:.1f} steps/s, "
                f"{eager.max_newton_steps} iterations); run_sim_steps"
                f"({ex.STEPS}) from the graph {r_ms:.4f} ms "
                f"({ex.STEPS * 1e3 / r_ms:.1f} steps/s)")
        else:
            graph_line = (f"graph times not reported: {rerun} steps ran "
                          f"again eagerly")
        print(f"config-1 sim step, the first {n} steps from rest, medians:"
              f" eager run_sim_step {e_ms:.4f} ms ({1e3 / e_ms:.1f} steps/s,"
              f" {iters:.2f} Newton iterations a step); {graph_line}; eager "
              f"run_sim_steps({ex.STEPS}) {re_ms:.4f} ms "
              f"({ex.STEPS * 1e3 / re_ms:.1f} steps/s) [{self.card}]",
              flush=True)

    # -- contact (collision_10k) ---------------------------------------------
    def qr_conv(self, card, cpu):
        """(z_card = conv @ z_cpu in float64, the same pivots): the
        block-diagonal K_card⁻¹ K_cpu, identity for objects without QR."""
        torch, f64 = self.torch, self.torch.float64

        def blocks(scene, name):
            return torch.block_diag(*(
                torch.eye(12 * o.num_handles, dtype=f64)
                if getattr(o, name) is None
                else getattr(o, name).cpu().to(f64)
                for o in scene.sim_obj_dict.values()))

        same = all(torch.equal(a.qr_tfm.cpu(), b.qr_tfm)
                   for a, b in zip(card.sim_obj_dict.values(),
                                   cpu.sim_obj_dict.values())
                   if a.qr_tfm is not None)
        return blocks(card, "qr_tfm_inv") @ blocks(cpu, "qr_tfm"), same

    def phase_collision_parity(self):
        """Contact on the card against the port's CPU version from the same
        inputs: each broad phase's pair set on three seeded scenes of 3 x 400
        points (and the grid's and the sweep's against the dense set on each
        device, the diagnostics equal); the stack scene's contact terms
        (``check_stack_step``); the demo scene's step, by B z, plain and
        padded with phantom points (``check_demo_steps``)."""
        torch = self.torch
        self.check_precision("phase_collision_parity")
        Collision = self.Collision
        for seed in COLLISION_SEEDS:
            dx, x0, ids = contact_clouds(seed)
            sets, diags = {}, {}
            for bp in ("dense", "grid", "sweep"):
                col = Collision(dt=0.02, collision_particle_radius=0.03,
                                broad_phase=bp, max_contacting_pairs=20000)
                if bp == "grid":
                    col.configure_grid(x0, obj_ids=ids)
                for dev in ("cpu", "cuda"):
                    args = [torch.from_numpy(a).to(dev) for a in (dx, x0, ids)]
                    c, d = col.detect_collisions(*args, return_diag=True)
                    sets[bp, dev] = pair_set(c)
                    diags[bp, dev] = {k: int(v) for k, v in d.items()}
            n = len(sets["dense", "cpu"])
            same = {bp: sets[bp, "cuda"] == sets[bp, "cpu"]
                    and diags[bp, "cuda"] == diags[bp, "cpu"]
                    for bp in ("dense", "grid", "sweep")}
            exact = all(sets[bp, dev] == sets["dense", dev]
                        for bp in ("grid", "sweep") for dev in ("cpu", "cuda"))
            self.check(all(same.values()) and exact and n > 0
                       and diags["dense", "cuda"]["contacts_overflow"] == 0,
                       f"contact pair sets, seed {seed}, {len(x0)} points: "
                       f"{n} pairs; card = CPU (sets and diagnostics) "
                       f"{same}; grid and sweep = dense on both devices "
                       f"{exact}; the most points in a cell "
                       f"{diags['grid', 'cuda']['max_cell_occupancy']}")
        self.check_stack_step()
        self.check_demo_steps()
        self.check_demo_steps({"grid": 8}, pad=COLLISION_DEMO_PAD)

    def step_system(self, scene, fn, consts, z_in):
        """The Newton system a step of ``scene`` starts from at state
        ``z_in``: its energy, gradient and Hessian at z, read by stepping
        with ``newtons_method`` replaced by a probe that records them."""
        sim = sys.modules[type(scene).__module__]
        real, got = sim.newtons_method, {}

        def probe(x, energy_fcn, gradient_fcn, hessian_fcn, **kw):
            got.update(energy=energy_fcn(x), gradient=gradient_fcn(x),
                       hessian=hessian_fcn(x))
            return x

        sim.newtons_method = probe
        try:
            with self.torch.no_grad():
                fn(consts, *z_in)
        finally:
            sim.newtons_method = real
        return got

    def check_stack_step(self):
        """The example's stack (2 x 300 points, a 10 x 10 plate) on the card
        against the CPU at 5 of the CPU's states: the card's detection from
        the CPU's displacement equals the CPU's (pairs in order), and the
        contact terms on those contacts at the step the CPU took (energy,
        gradient, Hessian, the pullbacks, the bounds) and the energy of the
        step's Newton system lie within 1e-4 of each one's largest entry.

        The rest of the step is printed, not held: this scene's QR rotation
        has entries up to 7.2e4 (sin(x·f) over a cube of side 0.5 leaves B's
        columns nearly dependent), so ``qr.T @ c_H @ qr`` turns contact
        Hessian entries of 1e8 into a Newton Hessian of some 6e3 whose
        value float32 rounding decides (the JAX package has the same
        rotations); and a 1e-7 change of z moves the next B z by a large
        share of max|B z|. The card's step is checked finite."""
        torch, ex, n = self.torch, self.col_ex, COLLISION_PARITY_STEPS
        f64 = torch.float64
        cpu = ex.stack_scene("cpu", **COLLISION_STACK)
        states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
        for _ in range(n):
            cpu.run_sim_step()
            states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
        card = ex.stack_scene("cuda", **COLLISION_STACK)
        _, same = self.qr_conv(card, cpu)
        fn, consts = card.build_functional_step(with_diag=True)
        fn_c, consts_c = cpu.build_functional_step(with_diag=True)
        col_k, col_c = consts["collision"], consts_c["collision"]
        term_errs, energy_errs, sys_errs, errs, flags, pairs = \
            [], [], [], [], [], []
        same_contacts, finite = True, True

        def rel(a, b):
            return float((a.cpu().double() - b.cpu().double()).abs().max()
                         / max(float(b.abs().max()), 1e-30))

        for k in range(n):
            z_in = [x.cuda() for x in states[k]]
            dx = (cpu.sim_B @ states[k][0]).reshape(-1, 3)
            c_c = col_c.detect_collisions(dx, cpu.sim_pts,
                                          cpu.qp_to_object_map,
                                          cpu.qp_is_kinematic,
                                          weights=consts_c["col_w"])
            c_k = col_k.detect_collisions(dx.cuda(), card.sim_pts,
                                          card.qp_to_object_map,
                                          card.qp_is_kinematic,
                                          weights=consts["col_w"])
            same_contacts &= all(torch.equal(getattr(c_k, f).cpu(),
                                             getattr(c_c, f))
                                 for f in ("indices_a", "indices_b", "valid"))
            pairs.append(int(c_c.valid.sum()))
            zq = consts_c["qr_tfm"] @ (states[k + 1][0] - states[k][0])
            terms = []
            for col, c, dev in ((col_c, c_c, "cpu"), (col_k, c_k, "cuda")):
                z_, d_ = zq.to(dev), 2.0 * zq.to(dev)
                g = col.gradient(c, coeff=1000.0, zq=z_)
                h = col.hessian(c, coeff=1000.0, zq=z_)
                terms.append([col.energy(c, coeff=1000.0, zq=z_), g, h,
                              col.pullback_gradient(c, g),
                              col.reduced_hessian(c, h),
                              col.get_bounds_q(c, d_, z_)])
            term_errs.append(max(rel(a, b) for b, a in zip(*terms)))
            want_sys = self.step_system(cpu, fn_c, consts_c, states[k])
            got_sys = self.step_system(card, fn, consts, z_in)
            energy_errs.append(rel(got_sys["energy"], want_sys["energy"]))
            sys_errs.append(max(rel(got_sys[key], want_sys[key])
                                for key in ("gradient", "hessian")))
            with torch.no_grad():
                out = fn(consts, *z_in)
            finite &= bool(torch.isfinite(out[0]).all())
            want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
            got = card.sim_B.cpu().to(f64) @ out[0].cpu().to(f64)
            errs.append(float((got - want).abs().max()
                              / want.abs().max()))
            flags.append(int(out[3]))
        rot = max(float(o.qr_tfm.abs().max())
                  for o in card.sim_obj_dict.values() if o.qr_tfm is not None)
        self.check(same and same_contacts and max(term_errs) <= SIM_Z_TOL
                   and max(energy_errs) <= SIM_Z_TOL and finite
                   and flags == [0] * n and min(pairs) > 0,
                   f"contact terms card vs CPU [stack {COLLISION_STACK}, "
                   f"{card.total_qp} points, D {card.total_dofs}, "
                   f"{col_k.broad_phase}], {n} states of the CPU: the same "
                   f"QR pivots {same}; contacts the same {same_contacts} "
                   f"({pairs} pairs); contact terms max err / max "
                   + ", ".join(f"{e:.1e}" for e in term_errs)
                   + "; the step's energy " + ", ".join(
                       f"{e:.1e}" for e in energy_errs)
                   + f"; not held (a QR rotation entry of {rot:.4g}): its "
                   "gradient and Hessian " + ", ".join(
                       f"{e:.1e}" for e in sys_errs)
                   + ", its max |d(B z)| / max|B z| "
                   + ", ".join(f"{e:.1e}" for e in errs)
                   + f"; the step finite {finite}, flags {flags} "
                   f"[{self.card}]")

    def check_demo_steps(self, steps=COLLISION_DEMO_STEPS, pad=None):
        """``make_demo_scene``'s scene (48 points, 3 handles, a 25-point
        plate; its QR rotation is small) on the card against the CPU for
        each broad phase of ``steps``: the card's step from each of the
        CPU's states, by B z within 1e-4 of max|B z| plus twice the card's
        own spread under a ±1e-7 change of z (about 1e-7 of max|B z| where
        the step is well conditioned; the CPU tests see 9.1e-5 at step 9,
        where contacts press into the barrier). ``pad`` pads both objects
        with phantom points (the example's ``demo_scene``), which contact
        leaves out."""
        torch, ex = self.torch, self.col_ex
        f64 = torch.float64
        what = "demo scene" if pad is None else f"padded demo scene {pad}"
        for bp, n in steps.items():
            cpu = ex.demo_scene("cpu", 3, broad_phase=bp, pad=pad,
                                **COLLISION_DEMO)
            states = [(cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot)]
            for _ in range(n):
                cpu.run_sim_step()
                states.append((cpu.sim_z, cpu.sim_z_prev, cpu.sim_z_dot))
            card = ex.demo_scene("cuda", 3, broad_phase=bp, pad=pad,
                                 **COLLISION_DEMO)
            conv, same = self.qr_conv(card, cpu)
            fn, consts = card.build_functional_step(with_diag=True)
            bk = card.sim_B.cpu().to(f64)
            u = torch.from_numpy(np.random.RandomState(0).choice(
                [-1.0, 1.0], card.total_dofs).astype(np.float32)).cuda()
            errs, spreads, flags = [], [], []
            for k in range(n):
                z_in = [(x if same else (conv @ x.to(f64)).float()).cuda()
                        for x in states[k]]
                size = max(float(x.abs().max()) for x in
                           (states[k][0], states[k + 1][0]))
                with torch.no_grad():
                    out = fn(consts, *z_in)
                    got = bk @ out[0].cpu().to(f64)
                    spread = max(float((bk @ fn(
                        consts, z_in[0] + e * size * u, *z_in[1:])[0]
                        .cpu().to(f64) - got).abs().max())
                        for e in (1e-7, -1e-7))
                want = cpu.sim_B.to(f64) @ states[k + 1][0].to(f64)
                scale = float(want.abs().max())
                errs.append(float((got - want).abs().max()) / scale)
                spreads.append(spread / scale)
                flags.append(int(out[3]))
            # the diagnostics at the CPU's last state, on both devices
            diag = {k: int(v) for k, v in cpu.collision_diagnostics().items()}
            card.sim_z = (states[n][0] if same else
                          (conv @ states[n][0].to(f64)).float()).cuda()
            card_diag = {k: int(v)
                         for k, v in card.collision_diagnostics().items()}
            card.reset_scene()
            pairs = diag["num_pairs"]
            rot = float(card.get_object(0).qr_tfm.abs().max())
            phantoms = int(card.qp_is_phantom.sum())
            self.check(all(e <= SIM_Z_TOL + 2 * s
                           for e, s in zip(errs, spreads))
                       and flags == [0] * n and pairs > 0
                       and card_diag["num_pairs"] > 0
                       and not any(card_diag.get(k) for k in (
                           "contacts_overflow", "cell_overflow",
                           "dropped_points", "out_of_bounds"))
                       and phantoms == card.total_qp - COLLISION_DEMO[
                           "num_qp"] - COLLISION_DEMO["kinematic_qp"]
                       and all(bool(torch.isfinite(x).all())
                               for x in states[-1]),
                       f"contact step card vs CPU [{what}, {bp}, "
                       f"{card.total_qp} points ({phantoms} phantom), D "
                       f"{card.total_dofs}], {n} "
                       f"steps from the CPU's states: max |d(B z)| / "
                       f"max|B z| " + ", ".join(f"{e:.1e}" for e in errs)
                       + " (the card's own spread under a 1e-7 change of z "
                       + ", ".join(f"{e:.1e}" for e in spreads)
                       + f"); flags {flags}; {pairs} pairs at the end; "
                       f"the card's diagnostics there {card_diag}, "
                       f"= the CPU's {card_diag == diag}; the "
                       f"same QR pivots {same}, the QR rotation's largest "
                       f"entry {rot:.4g} [{self.card}]")

    def collision_scene(self, graphs=False):
        return self.col_ex.collision_10k_scene("cuda",
                                               use_cuda_graphs=graphs)

    def col_heights(self, scene):
        """Each cube's mean height (the plate, the last object, left out)."""
        return [self.col_ex.mean_height(scene, i)
                for i in range(len(scene.sim_obj_dict) - 1)]

    def phase_collision_path(self):
        """``collision_10k`` at full size: steps and capacity checks until a
        20-step window needs no resize (at most three attempts, as bench.py
        runs it), then 20 eager steps and 20 from the CUDA graph from one
        start, every launch counter set to 0 before each and read after."""
        torch = self.torch
        self.check_precision("phase_collision_path")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scene = self.collision_scene()
        col = scene.force_dict["collision"]["object"]
        build_s = time.perf_counter() - t0
        print(f"collision_10k: {scene.total_qp} contact particles, "
              f"{len(scene.sim_obj_dict)} objects, D {scene.total_dofs} "
              f"({len(scene.dyn_idx)} dynamic), broad phase "
              f"{col.broad_phase}, grid dims {col.grid_dims}, K "
              f"{col.cell_capacity}, M {col.max_occupied_cells}, pp "
              f"{col.point_contact_capacity}, {col.max_contacts} contacts; "
              f"B {tuple(scene.sim_B.shape)}, dF/dz "
              f"{tuple(scene.sim_dFdz.shape)}; the QR rotations' largest "
              f"entries " + ", ".join(
                  f"{float(o.qr_tfm.abs().max()):.4g}"
                  for o in scene.sim_obj_dict.values()
                  if o.qr_tfm is not None)
              + f"; built in {build_s:.1f} s host", flush=True)
        t0 = time.perf_counter()
        for attempt in range(3):
            scene.run_sim_step()
            scene.check_collision_capacity()
            before = scene.collision_resizes
            scene.run_sim_steps(COLLISION_STEPS)
            if scene.collision_resizes == before:
                break
        torch.cuda.synchronize()
        print(f"collision_10k resize loop: {attempt + 1} attempts, "
              f"{scene.current_sim_step} steps, {scene.collision_resizes} "
              f"resizes, K {col.cell_capacity}, M {col.max_occupied_cells}, "
              f"pp {col.point_contact_capacity}, {col.max_contacts} "
              f"contacts; {time.perf_counter() - t0:.1f} s host", flush=True)
        settled = scene.collision_resizes == before
        start = [x.clone() for x in (scene.sim_z, scene.sim_z_prev,
                                     scene.sim_z_dot)]
        runs = {}
        for label, graphs in (("eager", False), ("graph", True)):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs

            def path():
                for _ in range(COLLISION_STEPS):
                    scene.run_sim_step()
                return scene.check_collision_capacity()

            t0 = time.perf_counter()
            flags, launches = self.drive(tuple(KERNELS), path)
            wall = time.perf_counter() - t0
            diag = scene.collision_diagnostics()
            runs[label] = dict(z=scene.sim_z.clone(), flags=flags,
                               pairs=int(diag["num_pairs"]),
                               heights=self.col_heights(scene),
                               launches=launches, wall=wall,
                               finite=all(bool(torch.isfinite(x).all())
                                          for x in (scene.sim_z,
                                                    scene.sim_z_dot)))
            r = runs[label]
            print(f"collision_10k, {COLLISION_STEPS} steps {label}: "
                  f"{wall:.3f} s host wall (the graph's capture included), "
                  f"flags {flags}, {r['pairs']} pairs at the end, cube mean "
                  f"heights " + ", ".join(f"{h:.4f}" for h in r["heights"])
                  + f", {scene.graph_steps_rerun} graph steps run again "
                  f"eagerly, {scene.graph_steps_lu} graph steps took the LU,"
                  f" kernel launches {launches} [{self.card}]", flush=True)
        print(f"collision_10k peak device memory allocated while the path "
              f"ran: {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"(the scene, its steps and its graph, and what earlier "
              f"phases still held) [{self.card}]", flush=True)
        B = scene.sim_B.to(torch.float64)
        be, bg = (B @ runs[k]["z"].to(torch.float64) for k in ("eager",
                                                               "graph"))
        err = float((be - bg).abs().max() / be.abs().max())
        low = min(min(r["heights"]) for r in runs.values())
        self.check(settled and all(r["finite"] and r["flags"] == 0
                                   and r["pairs"] > 0
                                   and not any(r["launches"].values())
                                   for r in runs.values())
                   and low > -0.6 and scene.graph_steps_rerun == 0
                   and err <= SIM_Z_TOL and col.broad_phase == "grid"
                   and scene.total_qp == 10712,
                   f"collision_10k path: a window without resize {settled} "
                   f"({scene.collision_resizes} resizes); eager and graph "
                   f"finite, flags 0, pairs "
                   f"{[r['pairs'] for r in runs.values()]}, no kernel "
                   f"launched; lowest cube mean height {low:.4f} above the "
                   f"floor at -0.6; {scene.graph_steps_rerun} graph steps "
                   f"run again eagerly; graph vs eager max |d(B z)| / "
                   f"max|B z| {err:.3e}")
        self.col.update(scene=scene, start=start, pairs=runs["eager"]["pairs"])
        self.check_resize_under_graph()

    def check_resize_under_graph(self):
        """A capacity resize under the CUDA graph: ``collision_10k``'s
        builder at 2 cubes of 1,100 points (2,216 particles, the grid) with
        64 contacts and a fan-out of 4 a point, eager and from the graph
        side by side, 3 steps a ``run_sim_steps`` call until the flags stay
        0: each overflow frees the graph, re-measures and doubles, and the
        next call captures anew; the two scenes resize alike and end
        together."""
        torch = self.torch
        scenes = [self.col_ex.collision_10k_scene("cuda", 2, 1100, 3, 16,
                                                  use_cuda_graphs=graphs)
                  for graphs in (False, True)]
        for scene in scenes:
            col = scene.force_dict["collision"]["object"]
            col.max_contacts, col.point_contact_capacity = 64, 4
        graph, seen = scenes[1], []
        for _ in range(6):
            for scene in scenes:
                scene.run_sim_steps(3)
            seen.append(scenes[0].collision_resizes)
            if graph._graph is not None:     # this call needed no resize
                break
        col = graph.force_dict["collision"]["object"]
        err = float((scenes[0].sim_B @ (scenes[0].sim_z - graph.sim_z)).abs()
                    .max() / (scenes[0].sim_B @ scenes[0].sim_z).abs().max())
        flags = [int(s._flags()) for s in scenes]
        self.check(graph.collision_resizes == scenes[0].collision_resizes >= 1
                   and flags == [0, 0] and err <= SIM_Z_TOL
                   and graph.graph_steps_rerun == 0
                   and bool(torch.isfinite(graph.sim_z).all()),
                   f"resize under the graph ({graph.total_qp} particles, "
                   f"{col.broad_phase}): resizes after each call {seen} "
                   f"(graph {graph.collision_resizes}), the graph captured "
                   f"{len(seen)} times, capacities now "
                   f"{col.max_contacts} contacts, fan-out "
                   f"{col.point_contact_capacity}, K {col.cell_capacity}, M "
                   f"{col.max_occupied_cells}; flags {flags}; graph vs eager "
                   f"max |d(B z)| / max|B z| {err:.3e}")

    def phase_collision_timing(self):
        """Steps/s of collision_10k from the path's start: eager
        ``run_sim_step``, one graph replay a step and ``run_sim_steps(20)``
        from the graph, CUDA-event medians."""
        torch = self.torch
        self.check_precision("phase_collision_timing")
        scene, start = self.col["scene"], self.col["start"]
        n = COLLISION_TIMED_STEPS

        def reset(graphs):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs

        reset(False)
        before = self.newton.iterations
        e_ms = statistics.median(self.time_ms(scene.run_sim_step, n))
        iters = (self.newton.iterations - before) / (n + 1)
        reset(True)
        rerun = scene.graph_steps_rerun
        g_ms = statistics.median(self.time_ms(scene.run_sim_step, n))
        reset(True)
        r_ms = statistics.median(self.time_ms(
            lambda: scene.run_sim_steps(COLLISION_STEPS), 3))
        rerun = scene.graph_steps_rerun - rerun
        flags = scene.check_collision_capacity()
        self.check(rerun == 0 and flags == 0,
                   f"collision_10k timed steps: {rerun} graph steps run "
                   f"again eagerly, flags {flags}")
        self.col.update(eager_ms=e_ms, graph_ms=g_ms, iterations=iters)
        print(f"collision_10k step, medians from the path's start: eager "
              f"run_sim_step {e_ms:.4f} ms ({1e3 / e_ms:.2f} steps/s, "
              f"{iters:.2f} Newton iterations a step); graph replay "
              f"{g_ms:.4f} ms ({1e3 / g_ms:.2f} steps/s, "
              f"{scene.max_newton_steps} iterations); run_sim_steps"
              f"({COLLISION_STEPS}) from the graph {r_ms:.4f} ms "
              f"({COLLISION_STEPS * 1e3 / r_ms:.2f} steps/s) [{self.card}]",
              flush=True)

    # -- training (the easy-API path of config 1) ----------------------------
    @contextlib.contextmanager
    def train_log(self):
        """The training steps' logged (step, le, lo), while inside."""
        from kaolin_tpu_torch.physics.simplicits import training

        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record.args)

        handler = Keep(level=logging.INFO)
        level = training.logger.level
        training.logger.addHandler(handler)
        training.logger.setLevel(logging.INFO)
        try:
            yield records
        finally:
            training.logger.removeHandler(handler)
            training.logger.setLevel(level)

    def torus_candidates(self, device):
        """The example's torus at full size and its 100,000 candidates from
        seed 0 on ``device``."""
        ex = self.train_ex
        verts, faces = ex.torus_mesh(device=device)
        return verts, faces, ex.candidates(verts, ex.CANDIDATES, seed=0)

    def train_step_fn(self, pts, seed=0):
        """``create_with_mlp``'s Adam step at full width (33 handles, 6
        layers, 1,000 samples, batch 10) on the points ``pts``, normalized
        to their box as ``create_with_mlp`` does, from a generator on their
        device → (step(i) → (le, lo), the MLP)."""
        torch, ex = self.torch, self.train_ex
        from kaolin_tpu_torch.physics.simplicits import (
            PhysicsPoints,
            SimplicitsMLP,
            training,
        )

        phys = PhysicsPoints(pts, 1e4, 0.45, 500.0, ex.torus_volume())
        gen = torch.Generator(device=pts.device).manual_seed(seed)
        lo, hi = pts.amin(dim=0), pts.amax(dim=0)
        mlp = SimplicitsMLP(3, 64, ex.NUM_HANDLES, ex.LAYERS, bb_min=lo,
                            bb_max=hi, key=gen)
        step = training._adam_step_fn(
            mlp, (pts - lo) / (hi - lo), phys,
            phys.appx_vol / float(torch.prod(hi - lo)), gen,
            num_samples=ex.NUM_SAMPLES, batch_size=ex.BATCH,
            num_steps=ex.TRAIN_STEPS, lr_start=1e-3, lr_end=1e-3,
            le_coeff=1e-1, lo_coeff=1e6)
        return step, mlp

    def check_sign_parity(self):
        """check_sign on the torus's 100,000 candidates, card against CPU:
        every candidate whose margin (``check_sign_margin``) exceeds
        ``CHECK_SIGN_MARGIN`` the same; → the CPU's interior mask."""
        torch, ex = self.torch, self.train_ex
        verts, faces, cand = self.torus_candidates("cpu")
        cpu = ex.check_sign(verts[None], faces, cand[None])[0]
        card = ex.check_sign(verts[None].cuda(), faces.cuda(),
                             cand[None].cuda())[0].cpu()
        differ = torch.nonzero(cpu != card)[:, 0].numpy()
        margins = check_sign_margin(verts.numpy(), faces.numpy(),
                                    cand.numpy()[differ])
        # the candidates near the surface: those whose answer on the card
        # changes when they move by the margin along an axis
        step = CHECK_SIGN_MARGIN * float((verts.amax(0) - verts.amin(0)).max())
        near = torch.zeros_like(cpu)
        for axis in range(3):
            for sign in (-1.0, 1.0):
                moved = cand.clone()
                moved[:, axis] += sign * step
                near |= ex.check_sign(verts[None].cuda(), faces.cuda(),
                                      moved[None].cuda())[0].cpu() != card
        self.check(all(m <= CHECK_SIGN_MARGIN for m in margins),
                   f"check_sign card vs CPU, the torus ({faces.shape[0]} "
                   f"faces), {cand.shape[0]} candidates: {len(differ)} "
                   f"differ, at margins "
                   f"{[float(f'{m:.2e}') for m in margins]} (each within "
                   f"{CHECK_SIGN_MARGIN:g} of an edge or face); the rest "
                   f"equal; {int(near.sum())} candidates lie near the "
                   f"surface (their answer changes on a move of "
                   f"{CHECK_SIGN_MARGIN:g} along an axis); {int(cpu.sum())} "
                   f"inside on the CPU")
        return cpu

    def phase_train_parity(self):
        """The training path's pieces on the card against the port's CPU:
        check_sign on the torus; the losses at full width from one set of
        weights and draws; 20 Adam steps from one generator (on the CPU:
        both devices get its initialization and draws); FPS with inf and
        NaN rows; the sparse builders."""
        torch, ex = self.torch, self.train_ex
        from kaolin_tpu_torch.ops import farthest_point_sampling as fps
        from kaolin_tpu_torch.physics.simplicits import (
            PhysicsPoints,
            SimplicitsMLP,
            SimplicitsObject,
            losses,
        )

        self.check_precision("phase_train_parity")
        inside = self.check_sign_parity()
        _, _, cand = self.torus_candidates("cpu")
        pts = cand[inside]
        lo, hi = pts.amin(dim=0), pts.amax(dim=0)
        tp = (pts - lo) / (hi - lo)
        n = pts.shape[0]
        mats = [torch.full((n,), v) for v in (1e4, 0.45, 500.0)]
        mlp = SimplicitsMLP(3, 64, ex.NUM_HANDLES, ex.LAYERS, key=3)
        idx, tfms = losses._draw_batch(torch.Generator().manual_seed(4), n,
                                       ex.NUM_SAMPLES, ex.BATCH,
                                       ex.NUM_HANDLES - 1)
        vals = {}
        with torch.no_grad():
            for label, dev, dt in (("cpu", "cpu", torch.float32),
                                   ("card", "cuda", torch.float32),
                                   ("cpu64", "cpu", torch.float64)):
                m = copy.deepcopy(mlp).to(device=dev, dtype=dt)
                vals[label] = [float(x) for x in losses._evaluate_losses(
                    m, tp.to(dev, dt), *(x.to(dev, dt) for x in mats), 0.5,
                    3.0, 0.1, 1e6, idx, tfms.to(dt))]
        errs = [abs(a - b) / abs(b) for a, b in zip(vals["card"],
                                                    vals["cpu"])]
        off64 = [abs(vals[k][0] - vals["cpu64"][0]) / abs(vals["cpu64"][0])
                 for k in ("cpu", "card")]
        self.check(max(errs) <= TRAIN_LOSS_RTOL,
                   f"training losses at full width ({n} points, "
                   f"{ex.NUM_SAMPLES} samples, batch {ex.BATCH}, interp "
                   f"0.5), card vs CPU from one set of weights and draws: "
                   f"le {vals['card'][0]:.6f} / {vals['cpu'][0]:.6f}, lo "
                   f"{vals['card'][1]:.3f} / {vals['cpu'][1]:.3f}, relative "
                   f"{errs[0]:.2e}, {errs[1]:.2e} (tolerance "
                   f"{TRAIN_LOSS_RTOL:g}); le from float64 on the CPU: CPU "
                   f"{off64[0]:.2e}, card {off64[1]:.2e}")
        # 20 Adam steps, card and CPU, one generator on the CPU
        logs, objs = {}, {}
        for label, dev in (("cpu", "cpu"), ("card", "cuda")):
            phys = PhysicsPoints(pts.to(dev), 1e4, 0.45, 500.0,
                                 ex.torus_volume())
            with self.train_log() as log:
                objs[label] = SimplicitsObject.create_with_mlp(
                    phys, ex.NUM_HANDLES, ex.NUM_SAMPLES, ex.LAYERS,
                    training_batch_size=ex.BATCH,
                    training_num_steps=TRAIN_PARITY_STEPS,
                    training_log_every=1,
                    key=torch.Generator().manual_seed(5))
            logs[label] = np.array(log)[:, 1:]
        rel = np.abs(logs["card"] - logs["cpu"]) / np.abs(logs["cpu"])
        w_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(
            objs["card"].skinning_mod.parameters(),
            objs["cpu"].skinning_mod.parameters())) / 1e-3
        self.check(rel.shape == (TRAIN_PARITY_STEPS, 2)
                   and float(rel.max()) <= TRAIN_LOSS_RTOL,
                   f"{TRAIN_PARITY_STEPS} Adam steps at full width card vs "
                   f"CPU: per-step losses relative "
                   f"{float(rel[:, 0].max()):.2e} (le), "
                   f"{float(rel[:, 1].max()):.2e} (lo), tolerance "
                   f"{TRAIN_LOSS_RTOL:g}; the weights part by {w_err:.3f} lr")
        # FPS with non-finite rows, card = CPU
        cloud = cand.clone()
        cloud[[17, 4242]] = float("inf")
        cloud[99, 1] = float("nan")
        cases = ((torch.as_tensor(self.sim_ex.config1_points()["pts"]), 256),
                 (cloud, 1000))
        same = []
        for p, k in cases:
            a = fps(p[None], k)
            b = fps(p[None].cuda(), k).cpu()
            same.append(bool(torch.equal(a, b)))
        self.check(all(same), f"FPS card = CPU: 256 of config 1's 1,000 "
                   f"points {same[0]}, 1,000 of the 100,000 candidates with "
                   f"inf and NaN rows {same[1]}")
        self.check_sparse_builders()

    def check_sparse_builders(self):
        torch = self.torch
        from kaolin_tpu_torch.physics.simplicits import precomputed as pre

        rng = np.random.RandomState(6)
        n, h = 300, 8
        x0, w = rng.rand(n, 3), rng.randn(n, h)
        dwdx, rhos = rng.randn(n, h, 3), rng.uniform(100, 1000, n)
        freqs = rng.randn(3, h - 1)
        idx = rng.randint(0, n, 64)
        static = rng.rand(64) < 0.3
        data = self.from_numpy_tree(
            dict(x0=x0, w=w, dwdx=dwdx, rhos=rhos, freqs=freqs),
            "cpu")
        data = {k: v.float() for k, v in data.items()}

        def builders(d, dev):
            def fn(x):
                return torch.cat([torch.sin(x @ d["freqs"]),
                                  x.new_ones((x.shape[0], 1))], 1)

            i = torch.as_tensor(idx, device=dev)
            s = torch.as_tensor(static, device=dev)
            return [pre.sparse_lbs_matrix(d["w"], d["x0"]),
                    pre.sparse_dFdz_matrix(d["w"], d["dwdx"], d["x0"]),
                    pre.sparse_dFdz_matrix_from_dense(fn, d["x0"]),
                    pre.sparse_mass_matrix(d["rhos"]),
                    pre.sparse_collision_jacobian_matrix(d["w"], d["x0"], i,
                                                         s)]

        cpu = builders(data, "cpu")
        card = builders({k: v.cuda() for k, v in data.items()}, "cuda")
        errs = [float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(card, cpu)]
        self.check(max(errs) <= 1e-5 and all(
            tuple(a.shape) == tuple(b.shape) for a, b in zip(card, cpu)),
            f"sparse builders card vs CPU ({n} points, {h} handles): "
            f"largest error over max|.| " + ", ".join(f"{e:.1e}" for e in errs)
            + " (lbs, dFdz, dFdz from the weight function, mass, collision "
            "jacobian)")

    def phase_train_path(self):
        """The example's path at full width on the card with every launch
        counter set to 0 just before and read just after: the torus's
        interior from 100,000 candidates, 1,000 Adam steps (33 handles, 6
        layers), the bake and 30 sim steps eager and 30 from the CUDA
        graph; then ``create_with_rkpm`` at config 1's 1,000 points (33
        handles, 256 nodes) and 10 sim steps of it. None of the six
        kernels may launch."""
        torch, ex = self.torch, self.train_ex
        from kaolin_tpu_torch.physics.simplicits import (
            PhysicsPoints,
            SimplicitsObject,
        )

        self.check_precision("phase_train_path")
        r = {}

        def path():
            verts, faces = ex.torus_mesh(device="cuda")
            pts, r["share"], box = ex.interior_points(verts, faces, seed=0)
            r["vol_share"] = ex.torus_volume() / box
            t0 = time.perf_counter()
            with self.train_log() as log:
                obj = ex.trained_object(pts, TRAIN_PATH_STEPS, seed=0,
                                        log_every=100)
            torch.cuda.synchronize()
            r["train_s"] = time.perf_counter() - t0
            r["log"] = np.array(log)
            r["n"] = pts.shape[0]
            w = obj.skinning_mod.compute_skinning_weights(pts)
            r["w_finite"] = bool(torch.isfinite(w).all())
            r["w_shape"] = tuple(w.shape)
            for label, graphs in (("eager", False), ("graph", True)):
                scene = ex.trained_scene(obj, use_cuda_graphs=graphs)
                heights = [ex.mean_height(scene)]
                for _ in range(TRAIN_SIM_STEPS // 10):
                    scene.run_sim_steps(10)
                    heights.append(ex.mean_height(scene))
                r[label] = (scene, heights)
            p1 = self.sim_ex.config1_points()
            phys = PhysicsPoints(torch.as_tensor(p1["pts"], device="cuda"),
                                 1e4, 0.45, 500.0, 1.0)
            t0 = time.perf_counter()
            robj = SimplicitsObject.create_with_rkpm(
                phys, RKPM_CASE["handles"], RKPM_CASE["nodes"])
            r["rkpm_s"] = time.perf_counter() - t0
            baked = robj.bake(num_qps=1000)
            scene = self.sim_ex.make_scene(
                {"pts": baked.pts, "w": baked.skinning_weights,
                 "dwdx": baked.dwdx}, "cuda", 0.01, 5, 10)
            heights = [self.sim_ex.mean_height(scene)]
            scene.run_sim_steps(RKPM_CASE["steps"])
            heights.append(self.sim_ex.mean_height(scene))
            r["rkpm"] = (scene, heights)

        _, launches = self.drive(tuple(KERNELS), path)
        share_err = abs(r["share"] - r["vol_share"]) / r["vol_share"]
        self.check(share_err <= INTERIOR_TOL,
                   f"torus interior: {r['n']} of {ex.CANDIDATES} candidates "
                   f"inside, share {r['share']:.4f} against the torus's "
                   f"volume share {r['vol_share']:.4f} of its box (relative "
                   f"{share_err:.4f}, tolerance {INTERIOR_TOL:g})")
        log = r["log"]
        total = log[:, 1] + log[:, 2]
        self.check(np.isfinite(log).all() and total[-1] < total[0]
                   and r["w_finite"] and r["w_shape"] == (r["n"],
                                                          ex.NUM_HANDLES),
                   f"{TRAIN_PATH_STEPS} training steps at full width in "
                   f"{r['train_s']:.2f} s host "
                   f"({TRAIN_PATH_STEPS / r['train_s']:.1f} steps/s with the "
                   f"set-up): le + lo at steps "
                   + ", ".join(f"{int(s)}: {v:.4g}"
                               for s, v in zip(log[:, 0], total))
                   + f"; weights {r['w_shape']} finite {r['w_finite']} "
                   f"[{self.card}]")
        (eager, he), (graph, hg) = r["eager"], r["graph"]
        B = eager.sim_B.to(torch.float64)
        be, bg = (B @ s.sim_z.to(torch.float64) for s in (eager, graph))
        err = float((be - bg).abs().max() / be.abs().max())
        for label, scene, h in (("eager", eager, he), ("graph", graph, hg)):
            self.check(all(bool(torch.isfinite(x).all())
                           for x in (scene.sim_z, scene.sim_z_dot))
                       and h[-1] < h[0] and min(h) > -1.0
                       and scene.graph_steps_rerun == 0,
                       f"trained torus (D {scene.total_dofs}), "
                       f"{TRAIN_SIM_STEPS} steps {label}: finite, mean "
                       f"heights " + ", ".join(f"{x:.4f}" for x in h)
                       + f" falling and above the floor at -1; "
                       f"{scene.graph_steps_rerun} graph steps run again "
                       f"eagerly")
        self.check(err <= SIM_Z_TOL, f"trained torus graph vs eager after "
                   f"{TRAIN_SIM_STEPS} steps: max |d(B z)| / max|B z| "
                   f"{err:.3e}")
        rs, rh = r["rkpm"]
        self.check(bool(torch.isfinite(rs.sim_z).all()) and rh[1] < rh[0],
                   f"create_with_rkpm at config 1's 1,000 points, "
                   f"{RKPM_CASE['handles']} handles, {RKPM_CASE['nodes']} "
                   f"nodes in {r['rkpm_s']:.2f} s host; "
                   f"{RKPM_CASE['steps']} sim steps finite, mean height "
                   f"{rh[0]:.4f} -> {rh[1]:.4f} [{self.card}]")
        self.check(not any(launches.values()),
                   f"training path kernel launches {launches} (it has no "
                   f"kernel)")

    def phase_grad(self):
        """The differentiable step's gradient on the card against the
        port's CPU at the graft scene's size: d/d(z, ż) of sum((B z')²) +
        sum((B ż')²) from a seeded state, both taken to the raw
        displacement (dL/dq = K⁻ᵀ dL/dz for z = K⁻¹ q), which does not
        depend on the QR basis."""
        torch, f64 = self.torch, self.torch.float64
        self.check_precision("phase_grad")
        grads = {}
        for label, dev in (("cpu", "cpu"), ("card", "cuda")):
            scene = self.sim_scene("graft", dev, differentiable=True)
            k_inv = scene.get_object(0).qr_tfm_inv.to("cpu", f64)
            rng = np.random.RandomState(7)
            q = torch.from_numpy(0.02 * rng.randn(k_inv.shape[0]))
            qd = torch.from_numpy(0.2 * rng.randn(k_inv.shape[0]))
            z, zd = ((k_inv @ v).float().to(dev).requires_grad_(True)
                     for v in (q, qd))
            step, c = scene.build_functional_step()
            zn, _, zdn = step(c, z, z.detach(), zd)
            loss = (c["B"] @ zn).square().sum() + (c["B"] @ zdn).square().sum()
            loss.backward()
            grads[label] = [k_inv.T @ g.to("cpu", f64) for g in (z.grad,
                                                               zd.grad)]
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads["card"], grads["cpu"])]
        big = [float(g.abs().max()) for g in grads["card"]]
        finite = all(bool(torch.isfinite(g).all()) for g in grads["card"])
        self.check(finite and min(big) > 0 and max(errs) <= GRAD_TOL,
                   f"differentiable step gradient (graft scene, D "
                   f"{k_inv.shape[0]}) card vs CPU: max|g| {big[0]:.4g} "
                   f"(z), {big[1]:.4g} (z_dot), errors over max|g| "
                   f"{errs[0]:.2e}, {errs[1]:.2e} (tolerance {GRAD_TOL:g}); "
                   f"finite {finite}")

    def phase_train_timing(self):
        """CUDA-event medians on the card: a training step at full width
        (steps 100 to 300 of one run, event to event), check_sign of the
        100,000 candidates, FPS (256 of 1,000, 1,000 of 100,000), one
        differentiable config-1 step forward and backward; and
        ``create_with_rkpm`` on the host clock."""
        torch, ex = self.torch, self.train_ex
        from kaolin_tpu_torch.ops import farthest_point_sampling as fps
        from kaolin_tpu_torch.physics.simplicits import (
            PhysicsPoints,
            SimplicitsObject,
        )

        self.check_precision("phase_train_timing")
        verts, faces, cand = self.torus_candidates("cuda")
        inside = ex.check_sign(verts[None], faces, cand[None])[0]
        pts = cand[inside]
        step, _ = self.train_step_fn(pts)
        a, b = TRAIN_TIMED
        events = []
        for i in range(b + 1):
            if i >= a:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            if i < b:
                step(i)
        torch.cuda.synchronize()
        step_ms = statistics.median(x.elapsed_time(y) for x, y in
                                    zip(events[:-1], events[1:]))
        cs_ms = statistics.median(self.time_ms(
            lambda: ex.check_sign(verts[None], faces, cand[None]), 5))
        p1 = torch.as_tensor(self.sim_ex.config1_points()["pts"],
                             device="cuda")
        fps_small = statistics.median(self.time_ms(lambda: fps(p1[None],
                                                               256), 5))
        fps_big = statistics.median(self.time_ms(lambda: fps(cand[None],
                                                             1000), 3))
        phys = PhysicsPoints(p1, 1e4, 0.45, 500.0, 1.0)
        rkpm_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            SimplicitsObject.create_with_rkpm(phys, RKPM_CASE["handles"],
                                              RKPM_CASE["nodes"])
            torch.cuda.synchronize()
            rkpm_s.append(time.perf_counter() - t0)
        scene = self.sim_scene("config1", "cuda", differentiable=True)
        fn, consts = scene.build_functional_step()
        z0 = scene.sim_z.detach().clone()

        def fwd_bwd():
            z = z0.clone().requires_grad_(True)
            zn, _, _ = fn(consts, z, scene.sim_z_prev, scene.sim_z_dot)
            (consts["B"] @ zn).square().sum().backward()

        grad_ms = statistics.median(self.time_ms(fwd_bwd, 5))
        self.train.update(step_ms=step_ms, check_sign_ms=cs_ms,
                          fps_ms=(fps_small, fps_big),
                          rkpm_s=statistics.median(rkpm_s), grad_ms=grad_ms,
                          points=pts.shape[0])
        print(f"training step at full width (33 handles, 6 layers, "
              f"{ex.NUM_SAMPLES} samples, batch {ex.BATCH}, "
              f"{pts.shape[0]} points), steps {a}-{b} of one run, median "
              f"event to event: {step_ms:.4f} ms ({1e3 / step_ms:.1f} "
              f"steps/s); check_sign of {ex.CANDIDATES} candidates against "
              f"{faces.shape[0]} faces {cs_ms:.4f} ms; FPS 256 of 1,000 "
              f"{fps_small:.4f} ms, 1,000 of 100,000 {fps_big:.4f} ms; "
              f"create_with_rkpm (1,000 points, 33 handles, 256 nodes) "
              f"{statistics.median(rkpm_s):.3f} s host (runs "
              + ", ".join(f"{s:.3f}" for s in rkpm_s)
              + f"); one differentiable config-1 step (D "
              f"{scene.total_dofs}, 5 Newton iterations) forward and "
              f"backward {grad_ms:.4f} ms [{self.card}]", flush=True)

    def profile_train(self):
        """One full-width training step, eager: device busy, idle share
        and the largest ops (``profile_path``)."""
        if "step_ms" not in self.train:
            raise RuntimeError("phase_train_timing did not run")
        ex = self.train_ex
        verts, faces, cand = self.torus_candidates("cuda")
        pts = cand[ex.check_sign(verts[None], faces, cand[None])[0]]
        step, _ = self.train_step_fn(pts, seed=1)
        count = iter(range(10 ** 6))
        for _ in range(20):
            step(next(count))
        self.train["busy"] = self.profile_path(
            "training step (full width, eager)", (),
            lambda: step(next(count)))

    def train_bound(self):
        """The training step's bound: its float32 operations over 67
        TFLOP/s, counted from the MLP's shapes. A step runs the MLP on
        7,000 rows (1,000 sample points and their 6,000 finite-difference
        probes), forward (2 operations a weight a row) and backward (twice
        the forward); the LBS of the probes under the batch's transforms,
        forward and backward, adds 3 x 2 x 12 (H - 1) x batch operations a
        probe; the energies and Adam are elementwise (under 1%). Bytes:
        Adam's weights and two moments read and written, the sampled
        points and their materials read, the transforms read."""
        ex = self.train_ex
        if "busy" not in self.train:
            raise RuntimeError("profile_train did not run")
        sizes = ([3] + [64] * (ex.LAYERS + 1) + [ex.NUM_HANDLES - 1])
        weights = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        rows = 7 * ex.NUM_SAMPLES
        mlp = 3 * 2 * weights * rows
        lbs = 3 * 2 * 12 * (ex.NUM_HANDLES - 1) * ex.BATCH * 6 * \
            ex.NUM_SAMPLES
        ops = mlp + lbs
        nbytes = 4 * (6 * weights + 6 * ex.NUM_SAMPLES
                      + 12 * (ex.NUM_HANDLES - 1) * ex.BATCH)
        t_ops = ops / FP32_OPS_S * 1e3
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        bound = max(t_ops, t_bytes)
        busy = self.train["busy"]
        print(f"training step bound: MLP {weights} weights x {rows} rows x "
              f"6 = {mlp / 1e9:.4f} GFLOP, LBS {lbs / 1e9:.4f} GFLOP -> "
              f"{t_ops:.6f} ms; {nbytes} bytes (weights and Adam moments in "
              f"and out, sampled points, transforms) -> {t_bytes:.6f} ms; "
              f"bound {bound:.6f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'}; device busy"
              f" {busy:.4f} ms (share {bound / busy:.4f}); a step "
              f"{self.train['step_ms']:.4f} ms (share "
              f"{bound / self.train['step_ms']:.4f}) [{self.card}]")

    def phase_probe_path(self):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                results, launches = self.drive(GATHER_KERNELS,
                                               lambda: self.pb.main([]))
        finally:
            print(buf.getvalue(), end="")
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        names = tuple(next(iter(x)) for x in lines[1:-1])
        self.check(names == PROBE_NAMES and lines[-1] == {"ALL": results},
                   f"primitives_bench printed every probe line ({len(names)}"
                   f" of {len(PROBE_NAMES)}) and the ALL line")
        print(f"probe path launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"probe path launched {k} ({n} times)")
        for name, n_tab in GATHER_TABLES.items():
            line = results.get(f"table_gather_n{1 << 20}_tab{n_tab}", {})
            route = name.removeprefix("table_gather_")
            self.check(line.get("correct") is True
                       and line.get("route") == route,
                       f"probe table_gather, 2^{n_tab.bit_length() - 1} "
                       f"table: route {line.get('route')}, correct "
                       f"{line.get('correct')}")

    def phase_gather_timing(self):
        print(f"timing on {self.card}", flush=True)
        for name, n_tab in GATHER_TABLES.items():
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            fn = self.gather_fn(name)
            k_ms, p_ms = self.compare_times(
                lambda: fn(table, idx),
                lambda: self.cg.table_gather_plain(table, idx), 50, 20)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name}, {n_tab} floats, {GATHER_IDX} indices: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)

    # -- the profile ---------------------------------------------------------
    def device_events(self, label, fn, reps, attempts=3):
        """``fn`` run once, then ``reps`` times under ``torch.profiler``
        → [(kernel or copy name, device µs)] of the profiled runs. The
        profiler now and then hands back a trace without device time; such
        a trace is taken again, up to ``attempts`` times."""
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA
        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            with self.profiling.trace(label, TRACE_DIR) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            # a user annotation (``Optimizer.step#Adam.step``) spans the
            # kernels it launched on the device's timeline: not counted
            events = [(e.name, e.time_range.elapsed_us())
                      for e in prof.events() if e.device_type == cuda
                      and not getattr(e, "is_user_annotation", False)]
            if any(us > 0 for _, us in events):
                return events
            print(f"{label}: the profiler recorded no device time; "
                  "tracing again", flush=True)
        raise RuntimeError(f"{label}: no device time in {attempts} traces")

    def wall_ms(self, fn, reps):
        """Host wall ms per call of ``fn`` over ``reps`` calls, synced,
        without the profiler."""
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_ms(self, label, fn, reps=20, names=None, alone=None):
        """Device ms per call of ``fn``, warm: every kernel and copy it
        launches, or those whose names hold one of ``names``. Where the
        profiler gives no device time (a trace of one or two short
        launches a call, inside a full run, now and then comes back
        without any), None: the device time is not measured. The
        CUDA-event ms of ``reps`` calls of ``alone`` (else ``fn``) back to
        back over ``reps``, which the host's launches overlap, is then
        printed as an event time, and kept nowhere as a device time."""
        try:
            events = self.device_events(label, fn, reps)
        except RuntimeError as err:
            one = alone or fn
            ms = statistics.median(self.time_ms(
                lambda: [one() for _ in range(reps)], 5)) / reps
            print(f"{err}: device time not measured; event time {ms:.4f} "
                  f"ms a call over {reps} calls back to back", flush=True)
            return None
        return sum(us for n, us in events if names is None
                   or any(x in n for x in names)) / reps / 1e3

    def profile_path(self, label, names, fn, n=PROFILE_STEPS, record=True):
        """Device busy ms a step of ``fn``, its idle share against the host
        wall, the kernels ``names``' device ms (helpers included) and
        launches a step, and the largest ops. ``record`` keeps the kernels'
        numbers as their kernel-table entries; else they are returned:
        (busy, {kernel: device ms})."""
        events = self.device_events(label, fn, n)
        busy = sum(us for _, us in events) / n / 1e3
        wall = self.wall_ms(fn, n)
        print(f"{label}: {len(events) / n:.1f} device ops per step, device "
              f"busy {busy:.4f} ms of {wall:.4f} ms host wall per step "
              f"(idle share {1 - busy / wall:.3f}) [{self.card}]")
        kernel_ms = {}
        for k in names:
            main, *helpers = DEVICE_NAMES[k]
            mine = [us for name, us in events if main in name]
            extra = [us for name, us in events
                     if any(h in name for h in helpers)]
            kernel_ms[k] = (sum(mine) + sum(extra)) / n / 1e3
            if record:
                self.results[k]["device_ms"] = kernel_ms[k]
                self.per_step[k] = len(mine) / n
            self.check(len(mine) > 0, f"{label} profile holds {k}")
            print(f"  {k}: {kernel_ms[k]:.4f} device ms "
                  f"({sum(extra) / n / 1e3:.4f} of it in "
                  f"{len(extra) / n:g} helper launches), "
                  f"{len(mine) / n:g} launches per step, "
                  f"{100 * kernel_ms[k] / busy:.1f}% of busy")
        top = {}
        for name, us in events:
            top[name] = top.get(name, 0.0) + us / n / 1e3
        for name, ms in sorted(top.items(), key=lambda x: -x[1])[:8]:
            print(f"    {ms:.4f} ms  {name[:160]}")
        return busy if record else (busy, kernel_ms)

    def phase_profile(self):
        torch = self.torch
        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        self.profile_path("config-2 step", DIBR_KERNELS,
                          lambda: self.ex.config2_grad(inputs, fvi, feats,
                                                       RES))
        rspc, cam, (tile_px, s_max, c_cap) = self.config3()
        self.profile_path("config-3 frame", SPC_KERNELS,
                          lambda: self.sr.raster_first_hit(
                              rspc, cam, tile_px=tile_px, s_max=s_max,
                              c_cap=c_cap))
        self.check_precision("phase_profile")
        self.profile_newton()
        eager = self.sim_scene("config1", "cuda")
        self.sim["eager_busy"] = self.profile_path(
            "config-1 sim step, eager", (), eager.run_sim_step)
        graph = self.sim_scene("config1", "cuda", use_cuda_graphs=True)
        try:
            busy = self.profile_path(
                "config-1 sim step, graph replay", (), graph.run_sim_step)
        except RuntimeError as err:    # the profiler may not see graphs
            print(f"graph replay profile: {err}; device time not measured")
        else:
            self.check(graph.graph_steps_rerun == 0,
                       f"profiled graph steps: {graph.graph_steps_rerun} "
                       f"run again eagerly")
            if graph.graph_steps_rerun == 0:
                self.sim["graph_busy"] = busy
        self.profile_collision()
        self.profile_train()
        self.profile_flexi()
        for k in (*DIBR_KERNELS, "spc_raster"):
            self.results[k]["library_ms"] = None
        b = self.spc_bins(rspc, cam, (tile_px, s_max, c_cap))
        dt, it = self.spc_tiles(True, rspc, b)
        self.results["spc_untile"]["library_ms"] = self.device_ms(
            "untile library",
            lambda: self.sr.untile_plain(dt, it, **b["size"]))
        self.profile_gather()
        torch.cuda.synchronize()

    def profile_gather(self):
        """The gathers cold (L2 flushed, as a caller that has just touched
        other data finds it) and warm (the same call repeated), beside
        ``table[idx]`` and the plain versions, then the route sweep: the
        share is taken cold, against a bound in HBM bytes."""
        for name, n_tab in GATHER_TABLES.items():
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            fn = self.gather_fn(name)
            ms = self.gather_readings(f"{name}, {n_tab} floats", {
                "kernel": lambda: fn(table, idx),
                "table[idx]": lambda: table[idx],
                "plain": lambda: self.cg.table_gather_plain(table, idx)})
            r = self.results[name]
            r["device_ms"], r["device_ms_warm"] = ms["kernel"]
            r["library_ms"], r["library_ms_warm"] = ms["table[idx]"]
            self.per_step[name] = 1
        self.gather_sweep()

    def gather_sweep(self):
        """Both routes, cold and warm, on every table the shared-memory
        route can hold, in three turns (shared memory first, then L2
        first, then shared memory first); a route's cold time is the median
        of its turns' cold readings. Printed beside it, the median leaving
        out any cold reading below the same turn's warm one (a trace in
        which the flush may not have held), and where the two medians
        disagree on the faster route. Where the routes cross cold (by the
        plain median) is where the route rule belongs."""
        faster = {}
        for n_tab in GATHER_SWEEP:
            table, idx = self.gather_case(n_tab, GATHER_IDX)
            fns = {name: lambda fn=self.gather_fn(name): fn(table, idx)
                   for name in GATHER_KERNELS}
            turns = [self.gather_readings(
                f"route sweep, {n_tab} floats, turn {k}",
                dict(sorted(fns.items(), reverse=k % 2 == 1)))
                for k in range(3)]
            cold, kept = {}, {}
            for name in fns:
                readings = [t[name] for t in turns
                            if t[name][0] is not None]   # cold measured
                below = [w is not None and c < w for c, w in readings]
                cold[name] = statistics.median(
                    [c for c, _ in readings] or [None])
                kept[name] = statistics.median(
                    [c for (c, _), b in zip(readings, below) if not b]
                    or [c for c, _ in readings] or [None])
                print(f"route sweep, {n_tab} floats, {name}: cold median "
                      f"{cold[name]}, leaving out cold below warm "
                      f"{kept[name]} ({sum(below)} of {len(readings)} left "
                      f"out; {3 - len(readings)} cold and "
                      f"{sum(w is None for _, w in readings)} warm readings "
                      f"not measured) [{self.card}]", flush=True)
            if None in cold.values():
                faster[n_tab] = None
                print(f"route sweep, {n_tab} floats: a route has no cold "
                      f"reading; not compared [{self.card}]", flush=True)
                continue
            ratio = cold["table_gather_l2"] / cold["table_gather_smem"]
            kept_ratio = kept["table_gather_l2"] / kept["table_gather_smem"]
            faster[n_tab] = "smem" if ratio >= 1 else "l2"
            print(f"route sweep, {n_tab} floats: cold, the L2 route is "
                  f"{ratio:.3f} x the shared-memory route ({kept_ratio:.3f} "
                  f"leaving out cold below warm"
                  + ("; the two disagree on the faster route"
                     if (kept_ratio >= 1) != (ratio >= 1) else "")
                  + f"; the rule takes {self.cg.gather_route(n_tab)}) "
                  f"[{self.card}]", flush=True)
        wins = [n for n in GATHER_SWEEP
                if all(faster[m] == "smem" for m in GATHER_SWEEP if m >= n)]
        print(f"route sweep: cold, the shared-memory route is no slower "
              f"from {min(wins, default=None)} floats up to "
              f"{max(GATHER_SWEEP)}; the rule takes it up to "
              f"{self.cg.SMEM_MAX_FLOATS}; not compared at "
              f"{[n for n in GATHER_SWEEP if faster[n] is None]} "
              f"[{self.card}]")

    def cold_ms(self, label, fn, reps=COLD_REPS, attempts=5):
        """Device ms of one call of ``fn`` with L2 cold: a 256 MB scratch
        is filled before each of ``reps`` profiled calls, which evicts the
        50 MB L2 → the median over the calls of the device time each one
        launched. The flush is the fill kernel with the most device time
        in the same trace, about 0.1 ms a call, and is left out (a separate
        trace of the flush alone came back without device time inside a
        full run). The profiler now and then drops a call's events: only the
        calls with as many device events as most calls have count, and at
        least ``COLD_MIN`` of them. None, printed "not measured", where no
        trace of ``attempts`` holds that many."""
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA
        if getattr(self, "_flush", None) is None:
            self._flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                      device="cuda")
        flush = self._flush
        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            with self.profiling.trace(label, TRACE_DIR) as prof:
                for _ in range(reps):
                    flush.fill_(1.0)
                    fn()
                torch.cuda.synchronize()
            events = sorted((e.time_range.start, e.name,
                             e.time_range.elapsed_us())
                            for e in prof.events() if e.device_type == cuda
                            and not getattr(e, "is_user_annotation", False))
            fills = {}
            for _, name, us in events:
                if "fill" in name.lower():
                    fills[name] = fills.get(name, 0.0) + us
            flush_name = max(fills, key=fills.get, default=None)
            calls = []   # [events, µs] a call
            for _, name, us in events:
                if name == flush_name:   # a call's flush: a new call begins
                    calls.append([0, 0.0])
                elif calls:
                    calls[-1][0] += 1
                    calls[-1][1] += us
            counts = [c for c, _ in calls if c]
            whole = [us for c, us in calls if counts
                     and c == statistics.mode(counts)]
            if len(whole) >= COLD_MIN:
                return statistics.median(whole) / 1e3
            print(f"{label}: {len(whole)} whole cold calls of {reps} in the "
                  "trace; tracing again", flush=True)
        print(f"{label}: no cold reading in {attempts} traces: cold device "
              "time not measured", flush=True)
        return None

    def gather_readings(self, label, fns):
        """Each of ``fns`` (name → a call at the probe's shape) cold and
        warm → {name: (cold device ms, warm device ms)}, printed side by
        side."""
        out = {}
        for name, fn in fns.items():
            out[name] = (self.cold_ms(f"{label} {name} cold", fn),
                         self.device_ms(f"{label} {name} warm", fn))
            print(f"{label}, {GATHER_IDX} indices: {name} cold "
                  f"{fmt_ms(out[name][0])}, warm {fmt_ms(out[name][1])} "
                  f"device ms [{self.card}]", flush=True)
        return out

    def profile_collision(self):
        """collision_10k from the path's start: an eager step and a graph
        replay (device busy, idle share, the largest ops), and detection
        alone at that state, its share of each."""
        torch = self.torch
        if "scene" not in self.col:
            raise RuntimeError("phase_collision_path did not run")
        scene, start = self.col["scene"], self.col["start"]
        busy = {}
        for label, graphs in (("eager", False), ("graph replay", True)):
            scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
                x.clone() for x in start)
            scene.use_cuda_graphs = graphs
            rerun = scene.graph_steps_rerun
            busy[label] = self.profile_path(f"collision_10k step, {label}",
                                            (), scene.run_sim_step,
                                            n=COLLISION_PROFILE_STEPS)
            self.check(scene.graph_steps_rerun == rerun,
                       f"profiled collision_10k {label} steps: "
                       f"{scene.graph_steps_rerun - rerun} run again eagerly")
        scene.sim_z, scene.sim_z_prev, scene.sim_z_dot = (
            x.clone() for x in start)
        col = scene.force_dict["collision"]["object"]
        w = scene.build_functional_step()[1]["col_w"]
        with torch.no_grad():
            dx = (scene.sim_B @ scene.sim_z).reshape(-1, 3)
        det = self.device_ms("collision_10k detection", lambda: (
            col.detect_collisions(dx, scene.sim_pts, scene.qp_to_object_map,
                                  scene.qp_is_kinematic, weights=w,
                                  return_diag=True)))
        self.col.update(eager_busy=busy["eager"],
                        graph_busy=busy["graph replay"], detection_ms=det)
        print(f"collision_10k detection alone (grid, from the start state): "
              f"{fmt_ms(det)} device ms, "
              f"{fmt_ms(det and det / busy['eager'], '.3f')} of an eager "
              f"step's busy time, "
              f"{fmt_ms(det and det / busy['graph replay'], '.3f')} of a "
              f"replay's [{self.card}]", flush=True)

    # -- bounds ------------------------------------------------------------
    def set_bound(self, name, nbytes, ops, what):
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / FP32_OPS_S * 1e3
        r = self.results[name]
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name}: {what}; {nbytes} bytes ({t_bytes:.6f} ms), {ops} "
              f"float32 operations ({t_ops:.6f} ms) -> bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}")

    def box_pairs(self, d, h, w, margin, closed, where=None):
        """(pixel, face) pairs with the pixel centre in the face's box,
        enlarged by ``margin``: closed as the winner search's, half open as
        the soft mask's; only at pixels where ``where`` (H, W) holds, when
        given → pairs per face, (F,)."""
        torch = self.torch
        px, py = self.rast._pixel_coords(h, w, 1000, torch.float32,
                                         d["fvi"].device)
        xs, ys = px[0], py[:, 0]
        v = d["fvi"][0]
        lo, hi = v.amin(dim=1) - margin, v.amax(dim=1) + margin

        def inside(c, k):
            upper = c[None] <= hi[:, k:k + 1] if closed else \
                c[None] < hi[:, k:k + 1]
            return ((c[None] >= lo[:, k:k + 1]) & upper).float()

        cols, rows = inside(xs, 0), inside(ys, 1)           # (F, W), (F, H)
        if where is None:
            return (rows.sum(dim=1) * cols.sum(dim=1)).long()
        # exact in float32: every partial count is below 2^24
        return ((rows @ where.float()) * cols).sum(dim=1).long()

    def sim_bound(self):
        """The config-1 sim step's bound: its float32 operations over 67
        TFLOP/s (the step's bytes, B, dF/dz and BMB read once, take far
        less). Counted per Newton iteration from the scene's sizes, the
        dense products and factorizations only (the elementwise material
        terms add under 1%): the gradient's four products with B and dF/dz
        and BMB·δ; the Hessian's dx and F, its batched (3x3 and 9x9) block
        products and its two (D, ·) x (·, D) reductions; Cholesky (D³/3)
        and LU (2D³/3) with their solves; the line search's QR turns and
        its K = 2m + 2 energies (a product with B and dF/dz each, and the
        kinetic term)."""
        r = self.sim
        if "dofs" not in r:
            raise RuntimeError("phase_sim_timing did not run")
        d, n, m = r["dofs"], r["points"], r["ls"]
        grad, hess, solve, search = dense_step_ops(d, n, m)
        per_iter = grad + hess + solve + search
        nbytes = 4 * (12 * n * d + d * d)
        for label, iters, ms in (
                ("graph (fixed trip)", r["newton"], r.get("graph_busy")),
                ("eager (stops early)", r["iterations"], r.get("eager_busy"))):
            ops = per_iter * iters
            t_ops = ops / FP32_OPS_S * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            busy = "not measured" if ms is None else \
                f"{ms:.4f} ms, share {bound / ms:.4f}"
            print(f"config-1 sim step, {label}: {iters:g} Newton iterations"
                  f" x {per_iter / 1e9:.4f} GFLOP ({grad / 1e6:.1f} M "
                  f"gradient, {hess / 1e6:.1f} M Hessian, {solve / 1e6:.1f} M"
                  f" solves, {search / 1e6:.1f} M line search) = "
                  f"{ops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms; {nbytes} bytes "
                  f"-> {t_bytes:.6f} ms; bound {bound:.6f} ms by "
                  f"{'operations' if t_ops >= t_bytes else 'bytes'}; device "
                  f"busy {busy} [{self.card}]")

    def grid_tests(self, scene):
        """The pairs the grid's narrow phase needs at the scene's state: in
        each occupied cell its pairs, and its points against those of its 13
        half-stencil neighbours (the capacities' padding not counted)."""
        col = scene.force_dict["collision"]["object"]
        if col.grid_dims is None:
            return scene.total_qp * (scene.total_qp - 1) // 2
        with self.torch.no_grad():
            cur = (scene.sim_pts + (scene.sim_B @ scene.sim_z).reshape(-1, 3)
                   ).cpu().numpy()
        dims = np.asarray(col.grid_dims)
        cell = np.clip(((cur - col.grid_origin) / np.float32(col.grid_cell)
                        ).astype(np.int64), 0, dims - 1)
        counts = {}
        for c in map(tuple, cell):
            counts[c] = counts.get(c, 0) + 1
        tests = 0
        offsets = ((0, 0, 1), (0, 1, -1), (0, 1, 0), (0, 1, 1),
                   (1, -1, -1), (1, -1, 0), (1, -1, 1), (1, 0, -1),
                   (1, 0, 0), (1, 0, 1), (1, 1, -1), (1, 1, 0), (1, 1, 1))
        for (x, y, z), n in counts.items():
            tests += n * (n - 1) // 2
            for ox, oy, oz in offsets:
                tests += n * counts.get((x + ox, y + oy, z + oz), 0)
        return tests

    def collision_bound(self):
        """collision_10k's step bound: the dense products counted as config
        1's are (``sim_bound``), object by object where the operators are
        block-diagonal (the work the step needs, not the zeros the dense
        scene matrices hold), over 67 TFLOP/s; plus the contact terms at
        this run's contact count C: per Newton iteration the offsets of the
        gradient, Hessian, bounds and the line search's K energies (2 sides
        x 2·3·4H·C each), the pullback (2·4H·3·C), the reduced Hessian's
        nine (4H, C) x (C, 4H) products (9·2·(4H)²·C) and ~200 elementwise
        operations a contact; once a step the narrow phase's tests (19
        operations a pair: two squared distances, the compares) and the
        compaction. Bytes: B and dF/dz blocks, BMB and the contact factors
        read once."""
        c = self.col
        if "iterations" not in c or "pairs" not in c:
            raise RuntimeError("the collision_10k phases did not run")
        scene = c["scene"]
        objs = list(scene.sim_obj_dict.values())
        d = scene.total_dofs
        d_dyn = len(scene.dyn_idx)
        nd = sum(o.num_qp * 12 * o.num_handles for o in objs)
        nd2 = sum(o.num_qp * (12 * o.num_handles) ** 2 for o in objs)
        m = scene.max_ls_steps
        k = 2 * m + 2
        grad = 4 * 2 * 12 * nd + 2 * d * d
        hess = 2 * 2 * 12 * nd + 2 * nd * (9 + 81) + 2 * 12 * nd2 \
            + 3 * d * d
        solve = d_dyn ** 3 / 3 + 2 * d_dyn ** 3 / 3 + 4 * 2 * d_dyn ** 2
        search = 2 * d * d + 2 * (k - 1) * d * d + k * (2 * 12 * nd
                                                       + 2 * d * d)
        h4 = d // 3
        cc = c["pairs"]
        offsets = (3 + k) * 2 * 2 * 3 * h4 * cc
        contact = offsets + 2 * h4 * 3 * cc + 9 * 2 * h4 * h4 * cc \
            + (200 + 9 * h4) * cc
        per_iter = grad + hess + solve + search + contact
        tests = self.grid_tests(scene)
        detect = tests * 19 + 16 * scene.total_qp
        nbytes = 4 * (12 * nd + d * d) + 4 * 2 * h4 * cc
        for label, iters, ms in (
                ("graph (fixed trip)", scene.max_newton_steps,
                 c.get("graph_busy")),
                ("eager (stops early)", c["iterations"], c.get("eager_busy"))):
            ops = per_iter * iters + detect
            t_ops = ops / FP32_OPS_S * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            busy = "not measured" if ms is None else \
                f"{ms:.4f} ms, share {bound / ms:.4f}"
            print(f"collision_10k step, {label}: {iters:g} Newton iterations"
                  f" x {per_iter / 1e9:.4f} GFLOP ({grad / 1e6:.1f} M "
                  f"gradient, {hess / 1e6:.1f} M Hessian, {solve / 1e6:.1f} M"
                  f" solves, {search / 1e6:.1f} M line search, "
                  f"{contact / 1e6:.1f} M contact terms at C = {cc}) + "
                  f"{detect / 1e6:.1f} M detection ({tests} pair tests) = "
                  f"{ops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms; {nbytes} bytes "
                  f"-> {t_bytes:.6f} ms; bound {bound:.6f} ms by "
                  f"{'operations' if t_ops >= t_bytes else 'bytes'}; device "
                  f"busy {busy} [{self.card}]")

    def gather_bounds(self):
        """The gathers' bounds in HBM bytes (the table once, 8 bytes an
        index), beside the L2 sector traffic of their random reads, and
        their shares cold and warm."""
        for name, n_tab in GATHER_TABLES.items():
            n = GATHER_IDX[0] * GATHER_IDX[1]
            self.set_bound(name, 4 * n_tab + 8 * n, 0,
                           f"a {n_tab}-float table once, {n} indices read "
                           f"and values written")
            r = self.results[name]
            cold = r["device_ms"] and r["bound_ms"] / r["device_ms"]
            warm = r["device_ms_warm"] and r["bound_ms"] / r["device_ms_warm"]
            print(f"{name}: the random reads' L2 sector traffic {n} x "
                  f"{L2_SECTOR} B = {n * L2_SECTOR} bytes (for understanding,"
                  f" not the bound); share cold {fmt_ms(cold)}, warm "
                  f"{fmt_ms(warm)} [{self.card}]")

    def phase_bounds(self):
        torch = self.torch
        d, h, w = self.sphere_case(RES)
        f = d["fvi"].shape[1]
        hw = h * w
        pairs1 = int(self.box_pairs(d, h, w, 0.0, True)[d["valid"][0]].sum())
        pairs2 = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False).sum())
        self.set_bound("winner", f * (12 + 24 + 1) + hw * 4,
                       pairs1 * WINNER_OPS,
                       f"{pairs1} (pixel, face) pairs in closed boxes x "
                       f"{WINNER_OPS}")
        face_ops = f * SOFT_FACE_OPS
        every = max((f * 24 + hw * 4) / HBM_BYTES_S,
                    (face_ops + pairs2 * SOFT_FWD_OPS) / FP32_OPS_S) * 1e3
        # on the main path the forward takes the rasterizer's ids and
        # computes only the pixels they leave uncovered
        ids = self.rast.rasterize_search_plain(d["fvz"], d["fvi"], d["valid"],
                                               1000, 1e-8, h, w)
        pairs2u = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False,
                                     ids[0] < 0).sum())
        self.set_bound("soft_mask_fwd", f * 24 + hw * 4 + hw * 4,
                       face_ops + pairs2u * SOFT_FWD_OPS,
                       f"faces, ids read, allprob written; {f} faces x "
                       f"{SOFT_FACE_OPS} ({face_ops}) + {pairs2u} pairs at "
                       f"uncovered pixels, of {pairs2} in the enlarged boxes, "
                       f"x {SOFT_FWD_OPS} ({pairs2u * SOFT_FWD_OPS}); every "
                       f"pixel computed: {every:.6f} ms")
        for name, margin, valid in (("winner", 0.0, d["valid"]),
                                    ("soft_mask_fwd", 0.02 * 1000.0, None)):
            lists = self.rast.tile_face_lists(d["fvi"], h, w, 1000,
                                              margin=margin,
                                              valid_mask=valid)[0]
            n = [len(x) for x in lists]
            busy = [x for x in n if x]
            print(f"{name}: {len(busy)} of {len(n)} tiles list a face, "
                  f"{statistics.mean(busy):.1f} faces a busy tile on average"
                  f" (most {max(busy)}), {sum(n)} listed in all")
        # the backward's pairs at pixels whose cotangent is zero (those the
        # rasterizer covers) add nothing: it needs only the others
        g, allprob = self.soft_cotangent(d, h, w)
        live = (g * allprob)[0] != 0
        pairs3 = int(self.box_pairs(d, h, w, 0.02 * 1000.0, False,
                                    live).sum())
        self.set_bound("soft_mask_bwd", f * 24 + hw * 4 + f * 24,
                       face_ops + pairs3 * SOFT_BWD_OPS,
                       f"{f} faces x {SOFT_FACE_OPS} ({face_ops}) + {pairs3}"
                       f" pairs with a non-zero cotangent, of {pairs2}, x "
                       f"{SOFT_BWD_OPS} ({pairs3 * SOFT_BWD_OPS})")

        rspc, cam, caps = self.config3()
        b = self.spc_bins(rspc, cam, caps)
        work = {}
        self.sr.raster_tiles_plain(b["tab"], b["counts"], b["dz"], b["cam"],
                                   rspc.l3boxes, rspc.units, rspc.uaabb,
                                   **b["size"], work=work)
        busy_px = int((b["counts"] > 0).sum()) * caps[0] ** 2
        l3 = int((rspc.l3boxes[:, 0] < 1.0e38).sum())
        tests = work["unit_tests"] + work["needed_leaf_tests"] + busy_px * l3
        ins = (b["tab"], b["counts"], b["dz"], b["cam"], rspc.l3boxes,
               rspc.units, rspc.uaabb)
        t_p = b["tab"].shape[1] * caps[0] ** 2
        self.set_bound("spc_raster", sum(x.numel() * 4 for x in ins)
                       + 2 * t_p * 4, tests * SLAB_OPS,
                       f"{tests} slab tests the walk needs "
                       f"({work['unit_tests']}"
                       f" (pixel, unit box), {work['needed_leaf_tests']} "
                       f"(pixel, leaf) of the units a ray enters nearer than "
                       f"its best, {busy_px * l3} (pixel, level-3 box) on "
                       f"{busy_px} pixels of busy tiles and {l3} boxes) x "
                       f"{SLAB_OPS}; every leaf of every unit walked would be "
                       f"{work['slab_tests']}")
        self.set_bound("spc_untile", 4 * t_p * 4, 0,
                       f"{t_p} depths and ids read, as many written")
        self.gather_bounds()
        torch.cuda.synchronize()
        self.sim_bound()
        self.collision_bound()
        self.train_bound()

        # the order in which to make the kernels faster: first those slower
        # than their library call, largest factor first; then by launches
        # per step x (device ms - bound ms)
        r = self.results
        timed = [k for k in r if r[k]["device_ms"] is not None]
        slower = sorted((k for k in timed if r[k]["library_ms"] is not None
                         and r[k]["device_ms"] > r[k]["library_ms"]),
                        key=lambda k: -r[k]["device_ms"] / r[k]["library_ms"])
        rest = sorted((k for k in timed if k not in slower),
                      key=lambda k: -self.per_step[k]
                      * (r[k]["device_ms"] - r[k]["bound_ms"]))
        untimed = [k for k in r if k not in timed]
        for i, k in enumerate(slower + rest + untimed, 1):
            lib, dev = r[k]["library_ms"], r[k]["device_ms"]
            print(f"order {i}: {k}: device {fmt_ms(dev)} ms, bound "
                  f"{r[k]['bound_ms']:.6f} ms ({r[k]['bound_by']}), share "
                  f"{fmt_ms(dev and r[k]['bound_ms'] / dev)}, library "
                  + ("none" if lib is None else f"{lib:.4f} ms")
                  + f", {self.per_step[k]:g} launches per step [{self.card}]")

    # -- slice 18: the SPC and mesh ops' device rule, the Newton bridge,
    #    parallel/ and the recipes ------------------------------------------
    def section_a_calls(self):
        """Each SPC and mesh op that builds on the host, as (name, call of
        (input maker, device))."""
        from kaolin_tpu_torch.ops import spc
        from kaolin_tpu_torch.ops.conversions import (
            unbatched_pointcloud_to_spc)
        from kaolin_tpu_torch.ops.mesh import (adjacency_matrix,
                                               uniform_laplacian)
        rng = np.random.RandomState(0)
        pts = rng.randint(0, 16, (3000, 3)).astype(np.int16)
        octree = spc.unbatched_points_to_octree(pts, 4, device="cpu").numpy()
        _, pyr, ex = spc.scan_octrees(octree, np.array([len(octree)]),
                                      device="cpu")
        ph = spc.generate_points(octree, pyr, ex, device="cpu").numpy()
        codes = np.unique(spc.points_to_morton(pts, "cpu").numpy())
        grid = rng.rand(1, 2, 5, 6, 4).astype(np.float32)
        grid[grid < 0.5] = 0.0
        cloud = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        faces = np.array([[0, 1, 2], [0, 2, 3], [1, 3, 2]])
        return [
            ("points_to_morton", lambda a, d: spc.points_to_morton(a(pts), d)),
            ("morton_to_points",
             lambda a, d: spc.morton_to_points(a(codes), d)),
            ("unbatched_points_to_octree",
             lambda a, d: spc.unbatched_points_to_octree(a(pts), 4,
                                                         device=d)),
            ("morton_to_octree",
             lambda a, d: spc.morton_to_octree(a(codes), 4, device=d)),
            ("scan_octrees", lambda a, d: spc.scan_octrees(
                a(octree), a(np.array([len(octree)])), device=d)[1:]),
            ("generate_points", lambda a, d: spc.generate_points(
                a(octree), a(pyr.numpy()), a(ex.numpy()), device=d)),
            ("feature_grids_to_spc",
             lambda a, d: spc.feature_grids_to_spc(a(grid), device=d)),
            ("unbatched_pointcloud_to_spc", lambda a, d: (
                lambda s: (s.octrees, s.lengths, s.features))(
                    unbatched_pointcloud_to_spc(a(cloud), 4, a(cloud),
                                                device=d))),
            ("adjacency_matrix",
             lambda a, d: adjacency_matrix(4, a(faces), device=d)),
            ("uniform_laplacian",
             lambda a, d: uniform_laplacian(4, a(faces), device=d)),
            ("build_raster_spc", lambda a, d: tuple(self.sr.build_raster_spc(
                a(ph), a(pyr[0].numpy()), 4, device=d))),
        ]

    def phase_device_defaults(self):
        """Each SPC and mesh op of the device rule, given numpy and no
        ``device``, builds on the card, equal to its CPU build bit for bit
        (NaN padding included)."""
        torch = self.torch

        def tensors(out):
            if isinstance(out, torch.Tensor):
                return [out]
            return [t for x in out for t in tensors(x)] \
                if isinstance(out, (list, tuple)) else []

        for name, call in self.section_a_calls():
            got = tensors(call(np.asarray, None))
            want = tensors(call(np.asarray, "cpu"))
            on_card = bool(got) and all(t.is_cuda for t in got)
            same = len(got) == len(want) and all(
                g.shape == w.shape and g.dtype == w.dtype and bool(
                    ((g.cpu() == w) | (g.cpu().isnan() & w.isnan())
                     if w.is_floating_point() else g.cpu() == w).all())
                for g, w in zip(got, want))
            self.check(on_card and same, f"{name} of numpy without device: "
                       f"on the card {on_card}, equal to its CPU build {same}")

    def newton_shapes(self, kind, device):
        from kaolin_tpu_torch.experimental import newton as tn
        pos, size = {0: ((0.0, -0.3, 0.0), (0.0, 0.0, 0.0)),
                     1: ((0.0, -1.0, 0.0), (0.8, 0.0, 0.0)),
                     2: ((0.0, -1.0, 0.0), (1.0, 0.7, 1.0))}[kind]
        q = NEWTON_Q_UP_Y if kind == 0 else (0.0, 0.0, 0.0, 1.0)
        return tn.RigidShapes(
            (kind,), np.asarray([pos], np.float32),
            np.asarray([q], np.float32), np.full((1, 3), 0.1, np.float32),
            np.full((1, 3), 0.05, np.float32), np.zeros((1, 3), np.float32),
            np.asarray([size], np.float32), [2e3], [1e3], [0.4],
            device=device)

    def phase_newton_parity(self):
        """The bridge's force on the card against the port's CPU: a plane,
        a sphere and a box, lagged and current friction, restitution 0.3
        and a velocity penalty: the energy within 1e-5 relative, the
        gradient and Hessian within 1e-5 of max|x|; ``detect`` within 1e-6
        of max|x| on random points, points inside the box, a tie of two of
        its gaps and the sphere's centre."""
        torch = self.torch
        from kaolin_tpu_torch.experimental import newton as tn
        rng = np.random.RandomState(4)
        special = np.asarray([[0.0, -1.0, 0.0], [0.2, -0.9, 0.1],
                              [0.5, -1.2, 0.5], [0.0, -1.0, 0.5],
                              [0.3, -1.0, 0.0], [-0.95, -1.0, 0.95]],
                             np.float32)
        pts = np.concatenate([rng.uniform(-2, 2, (4096, 3)).astype(
            np.float32), special])
        n = 4096
        vols = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
        x0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        prev = x0 + rng.randn(n, 3).astype(np.float32) * 0.02
        dx = (prev - x0) + rng.randn(n, 3).astype(np.float32) * 0.01

        def rel_max(got, want):
            want = want.cpu()
            return float((got.cpu() - want).abs().max()
                         / max(float(want.abs().max()), 1e-30))

        for kind, label in ((0, "plane"), (1, "sphere"), (2, "box")):
            det = {dev: self.newton_shapes(kind, dev).detect(
                torch.from_numpy(pts).to(dev)) for dev in ("cuda", "cpu")}
            err = max(rel_max(det["cuda"][k], det["cpu"][k])
                      for k in ("bx", "normal", "bv"))
            self.check(err <= 1e-6, f"newton detect {label} card vs CPU: "
                       f"{err:.2e} of max|x| (<= 1e-6)")
            for lagged in (True, False):
                out = {}
                for dev in ("cuda", "cpu"):
                    t = {k: torch.from_numpy(v).to(dev) for k, v in
                         (("vols", vols), ("x0", x0), ("prev", prev),
                          ("dx", dx))}
                    f = tn.ParticleShapeSoftContact(
                        self.newton_shapes(kind, dev), t["vols"], dt=0.02,
                        particle_mu=0.7,
                        friction_use_lagged_body_contact_force_norm=lagged,
                        velocity_penalty_kv_scale=0.5,
                        coeff_of_restitution=0.3)
                    f = f.with_step_state(t["prev"])
                    if lagged:
                        f = f.update_lagged_body_contact_force_norm(
                            t["prev"] - t["x0"], t["x0"])
                    out[dev] = (f.energy(t["dx"], t["x0"], 1.3),
                                f.gradient(t["dx"], t["x0"], 1.3),
                                f.hessian(t["dx"], t["x0"], 1.3))
                e_c, e_h = float(out["cuda"][0]), float(out["cpu"][0])
                e_rel = abs(e_c - e_h) / abs(e_h)
                g_err = rel_max(out["cuda"][1], out["cpu"][1])
                h_err = rel_max(out["cuda"][2], out["cpu"][2])
                self.check(e_h > 0 and e_rel <= 1e-5 and g_err <= 1e-5
                           and h_err <= 1e-5,
                           f"newton force {label}, "
                           f"{'lagged' if lagged else 'current'} friction, "
                           f"card vs CPU: energy {e_c:.6e} vs {e_h:.6e} "
                           f"(rel {e_rel:.2e}), gradient {g_err:.2e}, "
                           f"Hessian {h_err:.2e} of max|x| (<= 1e-5)")

    def newton_cube(self, add_shapes, device):
        """``tests/physics/test_newton_bridge.py``'s cube model on
        ``device`` and its solver."""
        from kaolin_tpu_torch.experimental import newton as tn
        from kaolin_tpu_torch.physics.simplicits import SkinnedPhysicsPoints
        rng = np.random.RandomState(0)
        g = np.linspace(-0.25, 0.25, 4)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
            -1, 3).astype(np.float32)
        freqs = rng.randn(3, 4).astype(np.float32)
        w = np.concatenate([np.sin(pts @ freqs), np.ones((len(pts), 1))],
                           1).astype(np.float32)
        dwdx = np.zeros((len(pts), 5, 3), np.float32)
        dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
        builder = tn.SimplicitsModelBuilder(up_axis="y", gravity=-9.8)
        builder.add_simplicits_object(SkinnedPhysicsPoints(
            pts=pts, yms=5e4, prs=0.45, rhos=500.0, appx_vol=0.125,
            skinning_weights=w, dwdx=dwdx))
        add_shapes(builder)
        builder.configure_soft_contact(particle_ke=5e4, particle_mu=0.5)
        model = builder.finalize(device=device, timestep=0.01,
                                 max_newton_steps=5, max_ls_steps=10,
                                 conv_tol=1e-9)
        model.simplicits_scene.force_dict["pt_wise"][
            "newton_soft_collisions"]["coeff"] = 1.0
        return model, tn.SimplicitsSolver(model)

    def phase_newton_path(self):
        """``examples/torch_newton_coupling.py`` as written on the card:
        120 finite steps; the cube above the plane and out of the sphere;
        the first 10 steps' B z within 1e-4 of max|B z| of the port's CPU
        run from the same state; the Timelapse's last checkpoint equal to
        the state it logged to the 6 significant digits the .usda keeps.
        Then the JAX tests' cube dropped onto a plane (80 steps) and a
        sphere (60) on the card, with their asserts. Each step of the
        rollout is timed by CUDA events (median)."""
        torch = self.torch
        import tempfile
        ex = load_example("torch_newton_coupling")
        os.makedirs(TRACE_DIR, exist_ok=True)
        out = tempfile.mkdtemp(prefix="newton_usd_", dir=TRACE_DIR)
        model, solver = ex.build(None)
        self.check(model.device.type == "cuda",
                   f"newton example builds on {model.device} by default")
        state = model.state()
        rest = model.simplicits_scene.sim_pts
        timelapse = ex.Timelapse(out)
        states, times = [], []
        for i in range(120):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = solver.step(state)
            end.record()
            states.append(state)
            if i % 10 == 0:
                timelapse.add_pointcloud_batch(
                    iteration=i, pointcloud_list=[state.particle_q],
                    category="soft_cube")
            end.synchronize()
            times.append(start.elapsed_time(end))
        q = torch.stack([s.particle_q for s in states]).cpu().numpy()
        finite = bool(np.isfinite(q).all())
        centre = np.array([0.05, -0.1, 0.0])
        low = float(q[-1][:, 1].min())
        deep = float(np.linalg.norm(q - centre, axis=-1).min())
        speeds = [float(torch.linalg.vector_norm(s.particle_qd, dim=-1).max())
                  for s in states]
        self.check(finite and low > -0.6 and deep > 0.1,
                   f"newton example, 120 steps: finite {finite}, lowest "
                   f"particle {low:+.4f} (> -0.6, the plane at -0.5), "
                   f"nearest to the sphere's centre {deep:.4f} (> 0.1, "
                   f"radius 0.2); max|v| {speeds[-1]:.3f} at the end, "
                   f"{max(speeds):.3f} at most")
        cpu_model, cpu_states, _ = ex.run("cpu", 10, quiet=True)
        rest_cpu = cpu_model.simplicits_scene.sim_pts
        errs = []
        for s_card, s_cpu in zip(states[:10], cpu_states):
            want = (s_cpu.particle_q - rest_cpu).double()
            got = (s_card.particle_q - rest).double().cpu()
            errs.append(float((got - want).abs().max() / want.abs().max()))
        self.check(max(errs) <= 1e-4, f"newton example, first 10 steps card "
                   f"vs CPU: B z within {max(errs):.2e} of max|B z| "
                   f"(<= 1e-4)")
        pc = self.usd_io.import_pointcloud(
            os.path.join(out, "soft_cube", "pointcloud_0.usda"), time=110,
            device="cpu")
        logged = states[110].particle_q.cpu()
        gap = float(((pc.points - logged).abs() / logged.abs().clamp(
            min=1e-30)).max())
        self.check(gap <= 5.2e-6, f"newton Timelapse checkpoint 110 = the "
                   f"state it logged to {gap:.2e} relative (the .usda's 6 "
                   f"significant digits, read back in float32: <= 5.2e-6)")
        step_ms = statistics.median(times)
        self.newton_ms = step_ms
        print(f"newton example step (125 particles, 8 handles, 2 shapes): "
              f"{step_ms:.4f} ms median over 120 steps, CUDA events "
              f"[{self.card}]", flush=True)

        for label, add, steps in (
                ("plane", lambda b: b.add_ground_plane(height=-0.5), 80),
                ("sphere", lambda b: b.add_shape_sphere(
                    (0.05, -1.3, 0.0), radius=0.8), 60)):
            model, solver = self.newton_cube(add, None)
            state = model.state()
            y0 = float(state.particle_q[:, 1].min())
            hs, vs = [], []
            for _ in range(steps):
                state = solver.step(state)
                hs.append(float(state.particle_q[:, 1].min()))
                vs.append(float(torch.linalg.vector_norm(
                    state.particle_qd, dim=-1).max()))
            qn = state.particle_q.cpu().numpy()
            if label == "plane":
                ok = (np.isfinite(hs).all() and min(hs) < y0 - 0.05
                      and hs[-1] > -0.6 and vs[-1] < 0.5 * max(vs))
                what = (f"falls to {min(hs):+.4f}, ends at {hs[-1]:+.4f} "
                        f"(> -0.6), |v| {vs[-1]:.4f} < half of "
                        f"{max(vs):.4f}")
            else:
                d = float(np.linalg.norm(
                    qn - np.array([0.05, -1.3, 0.0]), axis=-1).min())
                ok = np.isfinite(qn).all() and d > 0.7
                what = f"nearest to the centre {d:.4f} (> 0.7)"
            self.check(bool(ok), f"newton cube onto the {label} on the card, "
                       f"{steps} steps: {what}")

    def profile_newton(self):
        """The bridge's step in ``torch.profiler`` over 10 steps: device
        busy and idle share."""
        ex = load_example("torch_newton_coupling")
        model, solver = ex.build(None)
        box = [model.state()]

        def step():
            box[0] = solver.step(box[0])
        for _ in range(30):
            step()
        self.profile_path("newton example step", (), step)

    def parallel_mesh(self):
        """A group of world size 1 from a FileStore in a temporary
        directory (no port, no network), and its 1-D ``"dp"`` mesh: NCCL
        for the card's tensors, gloo for the CPU reference steps."""
        import tempfile

        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(tempfile.mkdtemp(prefix="nccl_", dir=TRACE_DIR),
                            "store")
        dist.init_process_group("cuda:nccl,cpu:gloo",
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1)
        return init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))

    def texfit_views(self):
        """Config 2 as written's 8 target views of the 4,992-face sphere at
        512²: DIB-R's inputs as ``texfit_render`` makes them."""
        torch = self.torch
        from kaolin_tpu_torch.render.mesh.utils import prepare_vertices
        ex = self.tex_ex
        scene = ex.texfit_setup(ex.texfit_inputs(), "cuda", RES)
        params = ex.initial_params(scene)
        with torch.no_grad():
            v = ex.posed_vertices(scene["template"], params)
            views = list(range(ex.VIEWS))
            fvc, fvi, normals = prepare_vertices(
                v[None], scene["faces"], scene["proj"],
                camera_transform=scene["cams"][views])
        uvs = scene["face_uvs"].expand(len(views), -1, -1, -1).contiguous()
        return (fvc[..., 2].contiguous(), fvi.contiguous(),
                [uvs, torch.ones_like(uvs[..., :1])],
                normals[..., 2].contiguous())

    @contextlib.contextmanager
    def plain_calls(self):
        """Count the calls of the four plain versions inside."""
        calls = {}
        saved = [(self.rast, "rasterize_search_plain"),
                 (self.rast, "interpolate_at_winners_plain"),
                 (self.dibr, "soft_mask_plain"),
                 (self.dibr, "_soft_mask_bwd_plain")]
        originals = [getattr(m, n) for m, n in saved]
        for (mod, name), fn in zip(saved, originals):
            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
        try:
            yield calls
        finally:
            for (mod, name), fn in zip(saved, originals):
                setattr(mod, name, fn)

    def phase_parallel_path(self):
        """``kaolin_tpu_torch.parallel`` on an NCCL group of world size 1:
        sharded DIB-R of config 2's 8 views at 512² bit for bit the
        unsharded call, forward and backward, through #1-3 and #8's forward
        and no plain version; the MLP step at ``create_with_mlp``'s widths
        card vs CPU; the scene batch of config 1's widths, padded, against
        each scene's own steps; 8 demo scenes with contact; sharded
        chamfer."""
        import torch.distributed as dist
        mesh = self.parallel_mesh()
        try:
            self.parallel_dibr(mesh)
            self.parallel_mlp(mesh)
            self.parallel_scenes(mesh)
            self.parallel_chamfer(mesh)
        finally:
            dist.destroy_process_group()

    def parallel_dibr(self, mesh):
        torch = self.torch
        from kaolin_tpu_torch.parallel import sharded_dibr_rasterization
        from kaolin_tpu_torch.render.mesh.dibr import dibr_rasterization
        fvz, fvi, feats, nz = self.texfit_views()

        def run(sharded):
            x = fvi.clone().requires_grad_(True)
            if sharded:
                outs = sharded_dibr_rasterization(mesh, RES, RES, fvz, x,
                                                  feats, nz)
                outs = ([o.to_local() for o in outs[0]],
                        *(o.to_local() for o in outs[1:]))
            else:
                outs = dibr_rasterization(RES, RES, fvz, x, feats, nz)
            (outs[1] ** 2).sum().backward()
            return outs, x.grad

        with self.plain_calls() as calls:
            (got, g_got), launches = self.drive(
                (*DIBR_KERNELS, "regather_fwd"), lambda: run(True))
        want, g_want = run(False)
        same = (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2]))
        self.check(same, "sharded DIB-R, 8 views of 4,992 faces at 512², "
                   "world size 1: image, soft mask and face ids bit for bit "
                   "the unsharded call's")
        self.check(torch.equal(g_got, g_want),
                   "sharded DIB-R: the soft-mask loss's gradient bit for bit "
                   "the unsharded call's")
        self.check(all(n > 0 for n in launches.values()) and not calls,
                   f"sharded DIB-R launched {launches}, plain versions "
                   f"called {calls or 'never'}")
        self.check(int((got[2] >= 0).sum()) > 0, "sharded DIB-R covers "
                   f"{int((got[2] >= 0).sum())} pixels")

        def fwd(sharded):
            with torch.no_grad():
                if sharded:
                    return sharded_dibr_rasterization(mesh, RES, RES, fvz,
                                                      fvi, feats, nz)
                return dibr_rasterization(RES, RES, fvz, fvi, feats, nz)

        for label, fn in (("forward", fwd), ("forward + backward", run)):
            for sharded in (True, False):
                ms = statistics.median(self.time_ms(lambda: fn(sharded), 10))
                busy, kms = self.profile_path(
                    f"{'sharded' if sharded else 'unsharded'} DIB-R "
                    f"{label}, 8 x 512²",
                    DIBR_KERNELS if label != "forward" else DIBR_KERNELS[:2],
                    lambda: fn(sharded), record=False)
                print(f"{'sharded' if sharded else 'unsharded'} DIB-R "
                      f"{label}, 8 views x 512², 4,992 faces: {ms:.4f} ms "
                      f"(CUDA events, median of 10); device busy "
                      f"{busy:.4f} ms; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in kms.items())
                      + f" device ms [{self.card}]", flush=True)

    def parallel_mlp(self, mesh):
        torch = self.torch
        from kaolin_tpu_torch.parallel import sharded_mlp_train_step
        from kaolin_tpu_torch.physics.simplicits import mlp_init
        rng = np.random.RandomState(0)
        pts = rng.uniform(-0.5, 0.5, (1000, 3)).astype(np.float32)
        params = mlp_init(torch.Generator().manual_seed(0), 3, 64, 33, 6)
        out = {}
        for dev in ("cuda", "cpu"):
            p = [{k: v.to(dev) for k, v in layer.items()} for layer in params]
            t = torch.from_numpy(pts).to(dev)
            args = (t, torch.full((1000,), 1e4, device=dev),
                    torch.full((1000,), 0.45, device=dev),
                    torch.full((1000,), 500.0, device=dev), 1.0)
            out[dev] = sharded_mlp_train_step(
                mesh, p, *args, torch.Generator().manual_seed(1),
                batch_size=10)
            if dev == "cuda":
                ms = statistics.median(self.time_ms(
                    lambda: sharded_mlp_train_step(
                        mesh, p, *args, torch.Generator().manual_seed(1),
                        batch_size=10), 10))
        (pc, lc), (ph, lh) = out["cuda"], out["cpu"]
        err = max(float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max())
                  for a, b in zip(pc, ph) for k in ("w", "b"))
        lrel = abs(float(lc) - float(lh)) / abs(float(lh))
        self.check(err <= 1e-5 and lrel <= 1e-5 and np.isfinite(float(lc)),
                   f"sharded MLP step (33 handles, 6 layers of 64, 1,000 "
                   f"points, batch 10) card vs CPU: params within {err:.2e} "
                   f"of max|p|, loss {float(lc):.6e} vs {float(lh):.6e} "
                   f"(rel {lrel:.2e})")
        print(f"sharded MLP step: {ms:.4f} ms (CUDA events, median of 10) "
              f"[{self.card}]", flush=True)

    def config1_scene(self, i, num_qp, num_handles, bucket=None):
        """A drop scene of config 1's kind on the card (``config1_points``
        of ``num_qp`` points and ``num_handles`` handles lifted by 0.1·i;
        QR, gravity, a floor at y = -1 with penalty 10,000; dt 0.01, 5
        Newton and 10 line-search steps), its object padded to ``bucket``
        when given."""
        from kaolin_tpu_torch.parallel.simplicits import (
            pad_skinned_physics_points)
        from kaolin_tpu_torch.physics.simplicits import (SimplicitsScene,
                                                         SkinnedPhysicsPoints)
        p = self.sim_ex.config1_points(num_qp, num_handles)
        baked = SkinnedPhysicsPoints(
            pts=p["pts"] + np.float32([0.0, 0.1 * i, 0.0]), yms=1e4,
            prs=0.45, rhos=500.0, appx_vol=1.0, skinning_weights=p["w"],
            dwdx=p["dwdx"])
        if bucket is not None:
            baked = pad_skinned_physics_points(baked, *bucket)
        scene = SimplicitsScene(timestep=0.01, max_newton_steps=5,
                                max_ls_steps=10, direct_solve=True,
                                device="cuda")
        scene.add_object(baked)
        scene.set_scene_gravity((0.0, 9.8, 0.0))
        scene.set_scene_floor(floor_height=-1.0, floor_axis=1,
                              floor_penalty=10000.0)
        return scene

    def batch_steps(self, mesh, scenes, steps, label):
        """``steps`` sharded batch steps → (z on the card, ms a step). Then
        one batched step split in two and printed: the sharded step,
        ``stack_scenes`` (each scene's step constants built, checked and
        stacked) and ``batch_step``, the vmapped step alone on constants
        stacked once, timed in turn for 5 rounds (host wall, synced,
        medians); the vmapped step's device busy ms, and the share of it
        in the batched LU's factorization kernels."""
        torch = self.torch
        from kaolin_tpu_torch.parallel import sharded_scene_batch_step
        from kaolin_tpu_torch.parallel.simplicits import (batch_step,
                                                          stack_scenes)
        state = sharded_scene_batch_step(mesh, scenes)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = None
        for _ in range(steps):
            state = sharded_scene_batch_step(mesh, scenes, state=state)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3 / steps
        step, consts, start = stack_scenes(scenes)
        parts = {"sharded": lambda: sharded_scene_batch_step(mesh, scenes),
                 "stack": lambda: stack_scenes(scenes),
                 "step": lambda: batch_step(step, consts, *start)}
        times = {k: [] for k in parts}
        with torch.no_grad():
            for _ in range(5):
                for k, fn in parts.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[k].append((time.perf_counter() - t0) * 1e3)
            events = self.device_events(f"{label}, the vmapped step alone",
                                        parts["step"], 3)
        ms = {k: statistics.median(v) for k, v in times.items()}
        busy = sum(us for _, us in events) / 3 / 1e3
        lu = [us for name, us in events
              if any(k in name for k in ("getf2", "laswp", "pivinfo"))]
        rest = ms["sharded"] - ms["stack"] - ms["step"]
        print(f"{label}: a sharded batch step {ms['sharded']:.4f} ms "
              f"= stack_scenes {ms['stack']:.4f} ms + the vmapped step "
              f"{ms['step']:.4f} ms + {rest:.4f} ms else (host wall, "
              f"synced, medians of 5 rounds in turn); "
              f"the vmapped step: {len(events) / 3:.1f} device ops, busy "
              f"{busy:.4f} ms (idle share {1 - busy / ms['step']:.3f}), "
              f"{sum(lu) / 3 / 1e3:.4f} ms of it in {len(lu) / 3:g} "
              f"launches of the batched LU's factorization (getf2, laswp, "
              f"pivinfo) [{self.card}]", flush=True)
        return state[0].to_local(), batch_ms

    def parallel_scenes(self, mesh):
        from kaolin_tpu_torch.parallel import make_demo_scene
        from kaolin_tpu_torch.parallel.simplicits import bucket_pad_targets
        sizes = [(1000, 33)] * 4 + [(800, 29)] * 4
        bucket = bucket_pad_targets(sizes)
        scenes, own, unpadded = ([self.config1_scene(i, nq, nh, pad)
                                  for i, (nq, nh) in enumerate(sizes)]
                                 for pad in (bucket, bucket, None))
        label = ("config-1 scene batch, 8 scenes of 1,000 points and 33 "
                 f"handles (4 of 800 and 29 padded to {bucket[0]} and "
                 f"{bucket[1]}), no contact")
        z, batch_ms = self.batch_steps(mesh, scenes, 10, label)
        self.scene_batch_report(
            label, [(s, o, z[i], nq) for i, (s, o, (nq, _)) in
                    enumerate(zip(scenes, own, sizes))], z, 10, batch_ms)
        # the padded scenes' real points against the unpadded scenes' (the
        # bound of tests/parallel/test_heterogeneous_batch.py)
        for o in unpadded:
            o.run_sim_steps(10)
        worst = 0.0
        for p_s, u_s, (nq, _) in zip(own, unpadded, sizes):
            got = p_s.get_object_deformed_pts(0)[:nq]
            want = u_s.get_object_deformed_pts(0)
            worst = max(worst, float(((got - want).abs()
                                      - 1e-4 * want.abs()).max()))
        self.check(worst <= 1e-5, f"config-1 padded scenes' real points "
                   f"against the unpadded scenes' after 10 steps: within "
                   f"rtol 1e-4 and atol 1e-5 (largest excess {worst:.2e})")

        demo = [make_demo_scene(s, device="cuda") for s in range(8)]
        own_demo = [make_demo_scene(s, device="cuda") for s in range(8)]
        label = "demo batch, 8 make_demo_scene with grid contact"
        z, batch_ms = self.batch_steps(mesh, demo, 3, label)
        self.scene_batch_report(
            label, [(s, o, z[i], 32)
                    for i, (s, o) in enumerate(zip(demo, own_demo))],
            z, 3, batch_ms)
        flags = [int(o._col_overflow) for o in own_demo]
        self.check(all(f == 0 for f in flags),
                   f"demo scenes' overflow flags after 3 steps {flags}")

    def scene_batch_report(self, label, own, z, steps, batch_ms):
        """Each scene's own ``run_sim_step``s against its row of the batch
        by B z of its real points (within 1e-4 of max|B z|; ``own`` holds
        (batched scene, the same scene stepped alone, its row of z, real
        points)), the batch's step time beside the sequential steps'."""
        torch = self.torch
        seq = 0.0
        errs, phantom = [], 0.0
        for s, o, zi, n in own:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                o.run_sim_step()
            torch.cuda.synchronize()
            seq += (time.perf_counter() - t0) * 1e3 / steps
            got = (s.sim_B.double() @ zi.double()).reshape(-1, 3)
            want = (o.sim_B.double() @ o.sim_z.double()).reshape(-1, 3)
            errs.append(float((got[:n] - want[:n]).abs().max()
                              / want[:n].abs().max()))
            if s.sim_obj_dict[0].pts.shape[0] > n:
                phantom = max(phantom, float(
                    got[n:s.sim_obj_dict[0].pts.shape[0]].abs().max()
                    / want[:n].abs().max()))
        finite = bool(torch.isfinite(z).all())
        self.check(finite and max(errs) <= 1e-4,
                   f"{label}: {steps} sharded batch steps finite {finite}, "
                   f"B z within {max(errs):.2e} of max|B z| of each scene's "
                   f"own run_sim_step (<= 1e-4); the phantom points moved "
                   f"{phantom:.2e} of it (not 0 in either package: ROADMAP "
                   f"Queue C)")
        print(f"{label}: {batch_ms:.4f} ms a batched step, {seq:.4f} ms "
              f"for the {len(own)} scenes' sequential run_sim_step (host "
              f"wall, synced) [{self.card}]", flush=True)

    def parallel_chamfer(self, mesh):
        torch = self.torch
        from kaolin_tpu_torch.metrics.pointcloud import chamfer_distance
        from kaolin_tpu_torch.parallel import sharded_chamfer_distance
        rng = np.random.RandomState(0)
        p1, p2 = (torch.from_numpy(rng.rand(8, 2048, 3).astype(
            np.float32)).cuda() for _ in range(2))
        got = sharded_chamfer_distance(mesh, p1, p2).to_local()
        want = chamfer_distance(p1, p2)
        rel = float(((got - want).abs() / want.abs()).max())
        self.check(rel <= 1e-6, f"sharded chamfer, 8 clouds of 2,048 x "
                   f"2,048: within {rel:.2e} relative of chamfer_distance")

    def phase_recipes(self):
        """Each torch recipe on the card prints what its CPU run prints:
        integers equal, floats within 1e-5 (the draws from a seeded CPU
        generator on both)."""
        import re
        number = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")
        for name in ("quaternions", "camera_recipes", "mesh_sampling",
                     "spc_basics", "spc_from_pointcloud"):
            path = os.path.join(ROOT, "examples", "recipes",
                                f"torch_{name}.py")
            spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            printed = {}
            for dev in ("cuda", "cpu"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    mod.main(dev)
                printed[dev] = buf.getvalue()
            got, want = printed["cuda"], printed["cpu"]
            # numpy widens a column for a sign: compare the words between
            # the numbers, their spacing aside
            ok = (" ".join(number.sub("#", got).split())
                  == " ".join(number.sub("#", want).split()))
            for g, w in zip(number.findall(got), number.findall(want)):
                if re.fullmatch(r"-?\d+", w):
                    ok = ok and int(g) == int(w)
                else:
                    ok = ok and abs(float(g) - float(w)) <= 1e-5 * max(
                        1.0, abs(float(w)))
            self.check(ok, f"recipe {name} on the card prints its CPU "
                       f"run's lines ({len(got.splitlines())} lines)")
            if not ok:
                print(got + "--- cpu\n" + want)

    def run(self):
        for phase in (self.phase_card, self.phase_build, self.phase_parity,
                      self.phase_spc_parity, self.phase_gather_parity,
                      self.phase_camera_defaults, self.phase_sim_parity,
                      self.phase_collision_parity,
                      self.phase_train_parity, self.phase_texfit_parity,
                      self.phase_regather_parity,
                      self.phase_main_path, self.phase_texfit_path,
                      self.phase_tutorials,
                      self.phase_spc_main_path, self.phase_spcrt_parity,
                      self.phase_spcrt_path, self.phase_spcrt_crosscheck,
                      self.phase_flexi_parity, self.phase_flexi_path,
                      self.phase_gauss_parity, self.phase_gauss_path,
                      self.phase_render_parity, self.phase_render_path,
                      self.phase_io_parity, self.phase_io_path,
                      self.phase_usd_parity, self.phase_usd_path,
                      self.phase_probe_path,
                      self.phase_sim_path, self.phase_collision_path,
                      self.phase_train_path, self.phase_grad,
                      self.phase_device_defaults, self.phase_newton_parity,
                      self.phase_newton_path, self.phase_parallel_path,
                      self.phase_recipes,
                      self.phase_timing, self.phase_texfit_timing,
                      self.phase_spc_timing,
                      self.phase_gather_timing, self.phase_sim_timing,
                      self.phase_collision_timing, self.phase_train_timing,
                      self.phase_flexi_timing, self.phase_gauss_timing,
                      self.phase_render_timing, self.phase_io_timing,
                      self.phase_usd_timing, self.phase_profile, self.phase_spcrt_timing,
                      self.phase_bounds):
            print(f"== {phase.__name__}", flush=True)
            t0 = time.perf_counter()
            try:
                phase()
            except Exception:   # report the phase, run the others
                traceback.print_exc()
                sys.stdout.flush()
                self.failures.append(phase.__name__)
                if phase in (self.phase_card, self.phase_build):
                    break
            finally:
                print(f"   ({phase.__name__}: {time.perf_counter() - t0:.1f}"
                      f" s)", flush=True)
        for name, r in self.results.items():
            missing = [k for k in ENTRY_KEYS[1:] if k not in r]
            self.check(not missing, f"{name} has every number ({missing} "
                       "missing)")
        return not self.failures


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smoke = Smoke()
    ok = smoke.run()
    if not ok:
        print(f"chip_smoke: FAILED {smoke.failures}", file=sys.stderr)
        return 1
    kernels = [{"name": name, **r} for name, r in smoke.results.items()]
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
