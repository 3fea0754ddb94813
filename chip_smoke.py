#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerf_shared_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. build    nvcc builds every kernel (B1-B5, P1-P2, and B1-B4 in bf16) from
            csrc/, one process per source, in parallel, into
            build/nerf_shared_tpu_torch/, and logs ptxas's registers and
            spills per kernel; cuobjdump counts the tensor-core MMA
            instructions of each kernel of B1's, B3's, B4's and B2's
            libraries: B1's nerf_points_tc_kernel, B3's nerf_rays_tc_kernel
            and B4's nerf_render_tc_kernel and their bf16 instantiations
            (nerf_points_bf16_kernel, nerf_rays_bf16_kernel,
            nerf_render_bf16_kernel), B1's IPE instantiation
            (nerf_points_ipe_kernel) and B2's tile kernels
            (nerf_bwd_kernel<true> / <false>, with and without dx,
            nerf_bwd_bf16_kernel, nerf_bwd_ipe_kernel)
            must have warpgroup MMAs (HGMMA), B2's nerf_dw_kernel and
            nerf_dw_bf16_kernel warp MMAs (HMMA).
2. kernels  at the lego width (8x256, skip at 4, viewdirs, multires 10/4)
            with seeded weights and rays at the main path's shapes (one ray
            block of --chunk 32768 rays): B3 at S=64 and S=192 and B4 at
            S=192 against their plain PyTorch versions (2e-4 of max(1,
            max|plain|), and B3's raw and B4's rgb, acc and weights also
            within 5e-6, fp32 accuracy, which one TF32 product alone does
            not reach), the other architectures at S = 1, 7, 65, B4 at
            S = 7 and 65 run 200 times each with every run bit-identical
            to the first (tiles there hold a ray's end and the next ray's
            start), B3 and B4 at S = 128 (the fern recipe's fine pass, 64
            + 64 samples) on NDC rays, one gradient through
            each autograd.Function, and times in turns with the plain
            versions (median and min-max of 10 samples) beside two bounds:
            the split-fp32 design's (3 TF32 products a multiply-add on the
            tensor cores) and the fp32 CUDA cores'. B5 (the composite) at
            32768 rays x S = 64, 192, 48 (guided), 32 (froxel K) and 128
            (fern, NDC rays) and at odd shapes (S=1, S=21 with 37 rays, opaque and empty rays), with
            and without a white background, and its gradient.
3. serving  a synthetic 800x800 blender scene loaded with configs/lego.txt
            (half_res: 400x400 frames), a .tar of seeded random lego-width
            weights, and the port's HTTP service on port 0: three render
            requests (GET and POST) and /metrics. Checks HTTP 200, decodable
            400x400x3 PNGs, a finite float frame that matches the plain
            renderer on a band of rays, and B3 and B5 each launched exactly
            2 x ceil(160000 / chunk) times per frame.
4. fused    one request through an engine with --fused_composite True: B4
            and B5 (the coarse pass) launched, pixels match phase 3's frame
            within 1e-3 on rays clear of the 1e10 sentinel.
5. training kernels
            B1 and B2 at the lego width with seeded weights at both training
            shapes of configs/lego.txt (1024 rays x 64 coarse samples =
            65,536 points; x 192 fine = 196,608) and the fine pass of
            configs/fern.txt (1024 NDC rays x 128 = 131,072), and at the odd
            shapes of
            phase 2 (the four architectures at 37 x 7 and 300 x 65 points),
            against their plain versions (B1 within 2e-4 and FP32_TOL of
            max(1, max|plain|), as B3); B1 timed in turns with the plain
            chain (median and min-max of 10 samples) beside both bounds,
            as B3, and its weight pack's time; B2 (within 1e-3 of each
            gradient's max) timed the same way (fused_mlp_backward: B1's
            training launch, which writes H, then B2), with B1's training
            launch's, B2's two kernels' and its reduction's device ms under
            the profiler, its host packs' ms and both bounds (the design's:
            all of B2's FLOPs in split fp32 on the tensor cores, 3 TF32
            products a multiply-add; all FLOPs on the fp32 CUDA cores), and
            20 runs at 196,608 points bit-identical to the first. Then one
            full training step of each recipe (lego: N_rand 1024, 64 + 128
            samples; fern: N_rand 1024, 64 + 64 samples, NDC, the batching
            sampler, sigma noise 1.0) through the kernels and through the
            plain path with the same draws (noise included): loss, every
            gradient and the post-Adam parameters must agree; the kernel
            step makes 2 B1 + 2 B2 launches and its B1 writes H for every
            point of the step (fused_mlp.SAVED_H_POINTS).
6. training a 3-D-consistent blender scene (benchmarks/hard_scene.py,
            800x800 frames -> 400x400 under half_res) trained with
            configs/lego.txt through apps/train.main for a few hundred
            steps, resumed for more, then --render_only --render_test.
            Checks B1 and B2 launched 2 x steps times, train PSNR rising,
            the held-out PSNR >= 2 dB above an all-white frame, Adam state
            in the .tar and .ckpt.npz, and the resume on the lr schedule.
7. fast     phase 6's checkpoint served over HTTP with configs/lego.txt
            through the fast engines: --render_guided 48, --render_gate
            1e-3, --occ_grid 128 --occ_keep 32 --occ_fine 16 (froxels) and
            the same with --occ_mode grid. Per engine: two requests of
            one pose giving the same finite 400x400 frame, /info's engine
            name, the B1/B3/B5 launches (exact where
            fixed: guided 10 B3 + 10 B5, a 128^3 grid build 128 B1), the
            frame against the same engine through the plain versions on the
            same grid within 1e-3 (rays whose difference is a flip of the
            1e10 sentinel excepted, at most 1 in 1000; guided and the
            --occ_fine pass, whose inverse-CDF samples move with the
            coarse pass's rounding, held at the kernel run's own depths,
            and the occupancy engines also as they are over the rays whose
            samples did not move (at most 3/4 of the live rays moved) and
            by their coarse pass alone as it is), latency, occupied
            fraction and PSNR against the dense frame and the held-out view.
            The 128^3 grid build timed through B1 and through the plain
            version in turns; each engine's frame ms and the build's on one
            line.
8. gather   P1 (row gather) and P2 (row scatter-add) against their plain
            versions: at the probe's shape (3,145,728 rows of 16 from
            65,536), the split L8/F8 hashgrid's per-level shapes (196,608
            and 65,536 rows of 64 from 4,096 and 16,384), the vertex
            L16/F2/T2^19 layout's one gather at a lego step's 262,144 points
            (33,554,432 rows of 2 from 8,388,608), triplane G256/C16
            (262,144 rows of 16 from 196,608), on uniform indices; then on
            main-path indices, built from seeded lego rays by the port's own
            index math (hashgrid_indices, triplane_indices): split levels 0,
            3 and 7 of a fine pass (196,608 rows of 64), the vertex
            layout's fine-pass gather (25,165,824 rows of 2 from 2^23) and
            one triplane plane gather (262,144 rows of 16); and odd shapes
            (R prime, R = 0, T = 1, w in 1, 2, 3, 4, 8, 16, 32, 64, buffers
            unaligned for the vector paths, all indices equal). P1 exact,
            P2 within 1e-5 of the largest |entry| (exact on integer
            updates). TableGather forward and backward against plain
            autograd. Timed: each kernel in turns with its library call
            (index_select; zeros + index_add_), median and min-max of 10
            samples, beside its plain version and its bytes bound over the
            distinct rows touched. Then the ported probe's eight rows.
9. grid     the split L8/F8/T14 hashgrid (--hash_max_res 512) trained with
            configs/lego.txt on phase 6's scene, resumed, --render_only, and
            served over HTTP (two requests): exact P1 / P2 / B5 launches per
            step and per frame, none of B1-B4, Adam groups in the
            checkpoint, the held-out PSNR >= 2 dB above an all-white frame,
            the frame against the same engine through the plain versions
            within 1e-3 (the fine pass at the kernel run's own depths).
            Then the hashgrid at its defaults (vertex L16/F2/T2^19) for 30
            steps (exactly 2 P1 + 2 P2 a step), and the triplane at its
            defaults for 100 steps with one upsample milestone (128 -> 256)
            and one served frame. Step and frame ms of each.
10. llff    benchmarks/hard_scene.py's forward-facing capture written in
            the LLFF disk format (poses_bounds.npy + 20 1512x2016 PNGs),
            minify_images x4 (378x504, fern's frame size), configs/fern.txt
            (8x256 MLPs, 64 + 64 samples, NDC, batching, sigma noise 1.0,
            --factor 4) trained through apps/train.main, resumed, and
            checked: B1 and B2 launched 2 x steps times and no other
            kernel, train PSNR rising, Adam state, the lr schedule. Then
            --render_only --render_test on the llffhold 8 views (B3 and B5
            each 2 x ceil(H W / chunk) a frame; held-out PSNR >= 2 dB above
            the better of an all-white and the training images' mean-colour
            frame; the first view against the plain versions at the kernel
            run's fine depths within 1e-3), the 120-pose spiral at
            --render_factor 4 as video.gif (GIF89a, 120 image descriptors
            counted by walking its blocks), apps/eval_cli.py (3 views, its
            mean PSNR within 1e-6 dB of render_only's float frames'), the
            checkpoint served over HTTP (POST of a held-out c2w: a 378x504x3
            PNG equal to render_only's) and through --fused_composite (B4).
            Prints step ms, frame ms and held-out PSNR on one line.
11. pose    camera poses on phase 6's 400x400 scene and 800-step lego
            checkpoint at full width (8x256, 64 + 128 samples, 512 rays a
            pose step: 32,768 + 98,304 points): B1 / B2 / B5 at those shapes
            against their plain versions; (a) one pose step (screw and
            se(3)) through B1 + B2 + B5, through B3 + B5 (--fused_backward
            false) and plain, the pixels and stratified depths pinned: loss
            within 1e-5 of plain, every pose gradient against the plain
            route in float64 within max(1e-3, 3x the plain fp32 route's own
            error) of its max (camera_held: two fp32 routes cannot meet
            1e-3 on a camera gradient); (b) one
            lego training step with pose twists, appearance and BARF mid-ramp
            past --refine_poses_from, kernels vs plain as phase 5's check,
            the twists and gains held as (a) holds a pose; (c) estimate_relative_pose on the
            model's own render of a test view perturbed by
            perturbation_matrix(3, 0, 4, 0.1), interest_region, 300 steps:
            loss, rotation and translation errors fall, exactly 600 B1, 300 B2
            (the loss reads the fine pass alone, as the JAX app's) and 600 B5
            launches; (d) apps/pose_cli.main on the scene's test
            image (100 steps): finite errors; (e) apps/train.main with
            --refine_poses --appearance --barf_anneal 400 for 150 steps,
            resumed to 200: 2 B1 + 2 B2 a step, the twists moved after
            --refine_poses_from (image 0's not), both groups and their Adam
            moments in the .ckpt.npz and restored exactly, eval frames at
            steps 100 and 200 mid-anneal. One "phase 11 pose" line with the
            pose-step and refine-step ms and the errors.
12. proposal the JAX package's quality-first recipe on phase 6's scene:
            configs/lego.txt with --proposal --loss_sampling --ema_decay
            0.99 --distortion_loss_weight 0.01 (a 2x64 density-only
            proposal MLP, always plain, as the coarse branch). (a) one
            step at full width (1024 rays, 64 + 128 samples, the fine pass
            196,608 points through B1 + B2) against the plain step with
            the same draws, the weighted tail included: the loss and its
            img / prop / dist parts within 1e-5, every proposal and fine
            gradient within 1e-3 of its max, the post-Adam parameters as
            phase 5, the EMA shadow and the updated loss map; and the host
            syncs of an unpinned loss-sampling step (under
            torch.cuda.set_sync_debug_mode("warn")) no more than a uniform
            step's. (b) apps/train.main 400 + 100 steps (--precrop_iters
            100): exactly 1 B1 + 1 B2 a step and no B3 while training,
            train PSNR rising, the ema/ sidecar in the .ckpt.npz restored
            exactly, the loss map off uniform; --render_only
            --render_test (5 B3 + 10 B5 a frame), held-out PSNR >= 2 dB
            above all-white, the frame within 1e-3 (sentinel flips set
            apart) of the plain renderer on the EMA weights at the kernel
            run's fine depths and apart from the raw weights' frame; one
            frame served over HTTP through --render_guided 48 (/info
            "ema": true), and --render_gate refused. (c) the mixed
            hierarchy (the proposal + the split L8/F8/T14 hashgrid) for
            100 steps: exactly 8 P1 + 8 P2 a step and nothing else, the
            tables' Adam group at --grid_lrate, one served frame against
            the plain versions within 1e-3. One "phase 12 proposal" line
            with the step, frame and PSNR numbers and the card's
            nvidia-smi name and power limit.
13. occ      the occupancy-gated trainer (--train_occ: C 64, K 32, a 64^3
            grid) at full lego width on phase 6's scene. (a) On phase 6's
            800-step weights: one density refresh (4 B1 launches of 65,536
            points) against the plain one with the jitter pinned (the EMA
            within 2e-4 of max(1, max|plain|), the binarized grids equal but
            for cells within 1e-4 of the threshold); one occ step with the
            warm-up's sigma noise and one budgeted step (--train_occ_budget)
            through B1 + B2 against the plain step, every draw pinned (loss
            1e-5, fine gradients 1e-3 of each max, coarse gradients exactly
            zero, post-Adam as phase 5); one max_probes refresh the same
            way. (b) apps/train.main from phase 6's checkpoint with
            --train_occ_warmup 850 --train_occ_until 1100 to step 1100, then
            resumed to 1200: exactly 1 B1 + 1 B2 an occ step and 4 B1 a
            refresh, one refresh per dispatch of gcd(i_print, i_weights,
            i_testset, i_img) steps; n_active_mean 32 in the warm-up; the
            grid below fully occupied after it; the hook frame through the
            training grid; [PHASE] at step 1100 with coarse and its Adam
            moments equal to fine's right after the sync; 2 B1 + 2 B2 a step
            after it; render_only held-out PSNR 2 dB above all-white. (c)
            300 steps from scratch (--train_occ_warmup 100): finite losses,
            train PSNR rising. (d) the vertex hashgrid at its defaults, 100
            steps: 1 P1 + 1 P2 an occ step (the fine pass only), no B1 / B2.
            One "phase 13 occ" line: occ step, refresh and post-switch step
            ms, the occupied fraction, held-out PSNR, rays/s against phase 6.
14. mesh     apps/mesh_cli.main on phase 6's checkpoint with --mesh_res 256
            --mesh_color --mesh_normals grad and the native scan required:
            the probe exactly 260 B1 launches of 65,536 points, no plain
            network anywhere in the export, the probe within 2e-4 of the
            plain probe on the 65^3 sub-lattice, the native scan and the
            numpy scan bit-equal on the 257^3 grid, faces at iso 50 (the
            99th percentile of sigma when the field stays below 50), every
            edge inside the box in two faces (the surface is open only where
            it leaves the probed box), colours in [0, 1] and within 1e-4 of the
            plain route, gradient normals (B1 + B2) unit and within 1e-3 of
            the plain route where |grad sigma| > 1e-3 of its max, the OBJ
            read back; then phase 10's fern checkpoint at --mesh_res 128
            with --mesh_world: finite world vertices, faces flipped. One
            "phase 14 mesh" line: probe ms, scan s (native, numpy), vertex
            and face counts, colour and normal ms.

15. bf16     --precision bf16 (the bf16 instantiations of B1, B2, B3 and
            B4). (a) Each against its plain bf16 version (bf16-rounded
            operands multiplied in fp32, fused_mlp.plain_mlp_bf16 and
            fused_mlp_bwd.plain_mlp_backward_bf16; within 1e-2 of max(1,
            max|plain|), B2 of each gradient's max) at the fp32 phases'
            shapes: B1 at 65,536 and 196,608 points, B3 at 32768 rays x S =
            64 and 192 (seeded weights), B4 at S = 192 on phase 6's trained
            fine network (rays clear of the 1e10 sentinel, at least 20% of
            them with acc > 0.5), B2 at 65,536 and 196,608 points on a
            seeded cotangent; each timed in turns with its plain version
            and with the fp32 kernel, beside its bound (FLOPs over 989
            TFLOP/s; B2 also its design bound: tile FLOPs over 67 + dW
            FLOPs over 989); B1, B3 and B4 at phase 2's other architectures
            (B4 with sigma's bias raised, so that at least half the rays
            held have acc > 0.5), B2 at 259 and 19,500 points. (b) On the
            same inputs bf16 against fp32: raw (B4: rgb, acc) within rtol =
            atol = 0.1, the JAX test's bar; the B2 gradients not at the JAX
            test's bar (norm within 2%, cosine above 0.999, which the JAX
            package's own bf16 backward misses at the lego width), but as
            close to fp32 as the plain bf16 version comes on the same
            inputs (each tensor's cosine within 1e-3 of the plain version's,
            its norm deviation within 5e-3 of it); the JAX bars' numbers
            logged, also at the JAX tests' own shapes. (c) Phase 6's
            checkpoint served with --precision bf16 (B3 + B5, exactly 10
            bf16 B3 and 10 B5 a frame) and with --fused_composite (5 bf16
            B4): each frame and its acc within 1e-2 of the plain versions
            of its bf16 kernels at its kernel run's fine depths (sentinel
            flips set apart, at most 1 in 1000), the B4 frame within 1e-3
            of the B3 + B5 one, PSNR >= 30 dB against the fp32 frame of the
            same checkpoint; each frame's ms; the plain bf16 network's
            route (apply_nerf in bf16) logged. (d) configs/lego.txt
            --precision bf16 trained through apps/train.main on phase 6's
            scene, 600 + 200 steps with a resume: exactly 2 bf16 B1 + 2
            bf16 B2 a step and no fp32 one, held-out PSNR >= 2 dB above
            all-white and no more than 1 dB below phase 6's; [TRAIN] ms and
            rays/s; one step through the bf16 kernels against the step
            through their plain versions, draws pinned (loss within 1e-3,
            every gradient within 1e-2 of its max), timed beside the fp32
            kernel step, with the plain bf16 network's step and the fp32
            step's gradient norms and cosines logged. One "phase 15 bf16"
            line with every number and the card's name and power limit.
16. debug, jpeg, parallel
            (a) --debug_nans: five lego steps (train_step_setup, B1 + B2
            twice a step) with the NaN checks off and on from one state
            and one set of draws: the parameters bit-equal, both step ms;
            a NaN put into B1's points must raise FloatingPointError
            naming B1; phase 6's checkpoint renders one --fused_composite
            frame (B3 + B5 coarse, B4 fine) with the checks on: nothing
            raised, a finite frame. (b) The committed JPEG fixtures
            (tests/data/jpeg/, written by Pillow) decode to Pillow's
            arrays bit for bit; the 640x480 4:2:0 fixture's decode rate
            (MPix/s, host). (c) An NCCL process group of one rank made in
            this process (a file:// store in a temporary directory):
            five lego steps and five occ steps through the data-parallel
            steps against the unsharded steps from the same state and
            draws, post-Adam parameters bit for bit, B1 + B2 launched;
            each step's ms with and without the all-reduce. One "phase
            16" line with the card's name and power limit.
17. sharded  the sharded renders and export. In an NCCL process group of
            one rank made in this process, on
            phase 6's checkpoint: (a) the sharded dense 400x400 frame
            (parallel/render.make_sharded_pose_render through the engine
            build_eval_engine makes under the world) against the unsharded
            engine's frame, bit for bit, exactly 2 B3 + 2 B5 a chunk of
            --chunk rays, and under --fused_composite (B3 + B5 coarse, B4
            fine), each frame's ms beside the unsharded one's; (b) the
            sharded froxel frame (--occ_grid 128 --occ_keep 32 --occ_fine
            16) against the unsharded froxel frame (tile skipping), rgb
            within 1e-5; (c) the sharded 129^3 density probe against the
            unsharded probe, bit for bit, 33 B1; (d) make_tp_apply at t = 1
            against apply_nerf on 65,536 points, within 1e-5; (e) the
            engines built under the world report "sharded-dense" and
            "sharded-froxel". One "phase 17" line with the card's name and
            power limit.
18. mip      mip-NeRF (--model_type mipnerf, portbench's mipnerf-lego: one
            8x256 network, IPE degrees [0, 16), 800x800 at lego's focal):
            B1's and B2's IPE instantiations on one pass of the step (4096
            seeded lego-like cones x 128 intervals = 524,288 Gaussians)
            against the plain fp32 network (TF32 off) on the same
            Gaussians: B1 within 2e-4 and FP32_TOL of max(1, max|plain|),
            B2's weight gradients each within twice the plain fp32 route's
            distance to float64 (+1e-5); the same network on Gaussians
            without their variances (no attenuation), with the mean's
            coordinates rotated (a column on the wrong input) and a degree
            up (a column at the next frequency) has to miss both
            tolerances; both timed in turns with the plain versions beside
            their two bounds. Then one training step (4096 rays x (128 +
            128) intervals) under set_sync_debug_mode("error") with the
            launch counters reset just before it: exactly 2 B1 IPE and 2
            B2 IPE launches, 1,048,576 Gaussians encoded; and its ms over
            5 steps. One "phase 18" line with the card's name and power
            limit, the step, and the two kernels' entries of the kernels
            line (launches, errors, ms, bound_ms).

``--parent-tree`` (with ``--phases``) marks the parent side of an A/B:
phase 1 logs a tensor-core kernel that tree predates instead of failing.
``--profile`` adds one dense frame, five training steps, one frame of
each fast engine, five split and five vertex hashgrid training steps, a
hashgrid and a triplane frame, five fern training steps and a fern
frame, and one dispatch window of the occ trainer (50 occ steps and a
refresh) under torch.profiler (device time by
kernel, device busy share, P1's and P2's shares). ``--phases 2,3,4,7``
runs the build and the listed phases alone (phases 7, 11, 12, 13, 14, 15,
16 and 17 run phase 6 for its checkpoint and scene, 14 phase 10 too; 3 and 4 run
together; no result lines; for iterating on a
phase and for nerf_shared_tpu_torch/benchmarks/ab_smoke.sh). Before the last
line it prints the whole script's time, the kernels JSON line and the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
# the card's peaks used for bounds (NVIDIA H100 SXM data sheet): fp32 on
# the CUDA cores, dense TF32 on the tensor cores (B1, B3 and B4 run split fp32,
# three TF32 products a multiply-add; the fp32 path uses no plain TF32) and
# HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the fern recipe's frame (configs/fern.txt at factor 8, or phase 10's
# 1512x2016 capture at factor 4) and its focal there (1.2 W)
FERN_H, FERN_W, FERN_FOCAL = 378, 504, 1.2 * 504
# B1's, B3's and B4's fp32-accuracy gate, beside the 2e-4 tolerance, as a
# share of max(1, max|plain|): split fp32 reads ~3.6e-7 at the lego width
# on an H100; one TF32 product a multiply-add alone (plain TF32) misses it
# by several times in tests/test_torch_tc_mlp.py's emulation of the kernel
FP32_TOL = 5e-6
# B2's ReLU decisions may differ from the float64 forward's only where the
# pre-activation lies within fp32 rounding of 0 (share of the layer's
# max|pre-activation|; bf16: the plain bf16 forward's, within about one
# bf16 rounding of it). Two fp32 routes switch such a unit each their own
# way (B2's forward is split fp32 on the tensor cores, the plain chain
# cuBLAS), which moves the gradients below it by up to ~1e-2 of their max
# at a training step's points, so B2 is held against its plain version on
# its own decisions (relu_masks). The H100 reads <= 1.4e-7 (fp32) and
# <= 8.5e-4 (bf16); a mask that tests the pre-activation before its bias
# reads ~1e-1 (PERF.md, Findings).
RELU_SWITCH, RELU_SWITCH_BF16 = 1e-6, 4e-3
# B3's and B4's design, and B1's, named in the kernels line
TC_DESIGN = ("split fp32 (3xTF32) on wgmma.m64nNk8 tensor cores, 128-point tiles, "
             "bulk-copy weight ring with mbarriers (csrc/mlp_tile_tc.cuh)")
B1_DESIGN = (TC_DESIGN + "; point-major encoder (f·x); each 8-row slice summed on the "
             "tensor cores from zero and added in fp32 on the CUDA cores")
B2_DESIGN = ("tile kernel: B1's 128-point tensor-core tile (csrc/mlp_tile_tc.cuh), input "
             "gradients dh = dz·W in split fp32 (3xTF32) on wgmma.m64nNk8 over the layer "
             "inputs H that B1's training launch wrote from its epilogues (no forward "
             "remat; nerf_bwd_kernel<false>, where no input needs a gradient, runs no GEMM "
             "into the embedding and forms no dx), each 8-row slice summed from zero and "
             "added in fp32, the weights through a bulk-copy ring, dZ written from the "
             "epilogues; "
             "nerf_dw_kernel: dW = H^T·dZ in split fp32 (3xTF32) on mma.sync.m16n8k8, "
             "128x128 output tiles over split-K point ranges, 3-stage cp.async ring, "
             "each k8 step summed on the tensor cores from zero and added in fp32 on "
             "the CUDA cores, narrow heads and biases fp32; fixed-order reduction of "
             "the ranges' partials (csrc/fused_mlp_bwd.cu)")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of ``fn`` on the card, fenced with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def queued_ms(fn, reps=20, rounds=3):
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls queued behind a ~30 ms spin kernel, so the host's per-call cost
    stays off the clock while it enqueues ahead (a call that waits for the
    card, as the plain versions' range checks do, counts that wait);
    median of ``rounds``. The profiler recorded only part of long sessions
    of short launches on the H100 (times below the bytes bound, or none)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / reps)
    return statistics.median(ts)


def lego_rays(n, S, seed, device):
    """Seeded rays like a 400x400 lego frame's: origins on the radius-4
    orbit, directions through the scene, depths in [2, 6] (S=64: the
    perturb-0 linspace; S=192: that union 128 inverse-CDF-like draws)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) * 2 * math.pi
    o = torch.stack([4 * torch.sin(theta), 1.5 * torch.ones(n),
                     4 * torch.cos(theta)], -1)
    d = -o + torch.randn(n, 3, generator=g) * 0.8
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True) * (
        1 + 0.1 * torch.rand(n, 1, generator=g))
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.linspace(2.0, 6.0, 64).expand(n, 64)
    if S > 64:
        extra = 2.0 + 4.0 * torch.rand(n, S - 64, generator=g)
        z = torch.sort(torch.cat([z, extra], -1), -1).values
    to = dict(device=device, dtype=torch.float32)
    return (o.to(**to).contiguous(), d.to(**to).contiguous(),
            z.to(**to).contiguous(), vd.to(**to).contiguous())


def fern_rays(n, S, seed, device):
    """Seeded NDC rays like a fern-recipe frame's (configs/fern.txt on phase
    10's 378x504 forward-facing capture, focal 1.2 W): pixels of cameras
    clustered near the origin looking down -z, warped by ndc_rays (near
    plane 1), view directions from the world rays, depths in [0, 1] (the
    perturb-0 linspace of 64; S > 64: that union S - 64 uniform draws,
    sorted, as the fine pass's)."""
    import torch

    from nerf_shared_tpu_torch.ops.rays import ndc_rays

    g = torch.Generator().manual_seed(seed)
    x, y = torch.rand(n, generator=g) * FERN_W, torch.rand(n, generator=g) * FERN_H
    d = torch.stack([(x - FERN_W / 2) / FERN_FOCAL, -(y - FERN_H / 2) / FERN_FOCAL,
                     -torch.ones(n)], -1)
    o = 0.2 * (torch.rand(n, 3, generator=g) - 0.5)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o, d = ndc_rays(FERN_H, FERN_W, FERN_FOCAL, 1.0, o, d)
    z = torch.linspace(0.0, 1.0, 64).expand(n, 64)
    if S > 64:
        z = torch.sort(torch.cat([z, torch.rand(n, S - 64, generator=g)], -1), -1).values
    to = dict(device=device, dtype=torch.float32)
    return (o.to(**to).contiguous(), d.to(**to).contiguous(),
            z[:, :S].to(**to).contiguous(), vd.to(**to).contiguous())


def bound(cfg, params, n, S, products=1, peak=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by) of the network on n rays x S samples: its FLOPs
    times ``products`` (TF32 products a multiply-add) over ``peak`` vs its
    bytes (rays, depths, weights in; raw out) over the memory rate."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    flops = flops_per_point(cfg) * n * S * products
    nbytes = 4 * (n * 9 + n * S + n * S * 4) + network_bytes(params, cfg)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_bounds(cfg, params, n, S):
    """B3's and B4's two bounds: (design ms, by), (fp32 CUDA-core ms, by)."""
    return (bound(cfg, params, n, S, products=3, peak=PEAK_TF32_FLOPS),
            bound(cfg, params, n, S))


def points_bounds(cfg, params, n, S):
    """B1's two bounds on n rays x S points, as mlp_bounds: its bytes are
    the points and the rays' directions in, raw out, and the weights."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    nbytes = 4 * (n * 3 + n * S * 3 + n * S * 4) + network_bytes(params, cfg)
    out = []
    for products, peak in ((3, PEAK_TF32_FLOPS), (1, PEAK_FP32_FLOPS)):
        t_ops = flops_per_point(cfg) * n * S * products / peak
        t_bytes = nbytes / PEAK_BYTES
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return tuple(out)


def spread(t):
    return f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]"


def abs_err(got, want, tol, fp32=False):
    """(max |got - want|, whether it is within min(tol, FP32_TOL if
    ``fp32``) * max(1, max|want|))."""
    err = float((got - want).abs().max())
    return err, err <= min(tol, FP32_TOL if fp32 else tol) * max(1.0, float(want.abs().max()))


def render_errs(got, want, mask, tol):
    """abs_err of B4's outputs (rgb, disp, acc, weights, depth) over the
    rays ``mask`` marks: rgb, acc and weights also within FP32_TOL (disp
    and depth pass through a division and the depth scale)."""
    return [abs_err(g[mask], w[mask], tol, fp32=i in (0, 2, 3))
            for i, (g, w) in enumerate(zip(got, want))]


def rays_at(n, S, seed, device):
    """lego_rays with S samples a ray: the first S of 64 for S <= 64, else
    64 more depths 0.01 past the first S - 64 merged in."""
    import torch

    o, d, z, vd = lego_rays(n, 64, seed=seed, device=device)
    z = z[:, :S].contiguous() if S <= 64 else torch.sort(torch.cat(
        [z, z[:, :S - 64] + 0.01], -1), -1).values.contiguous()
    return o, d, z, vd


def check_other_shapes(device, tol):
    """B3 and B4 against their plain versions on the architectures the TPU
    kernels also take: no viewdirs (output_ch 5), the stonehenge encoder
    (multires 15/6: 132 embedding columns), identity embedding, odd widths
    and depths, two skips, and sample counts that fill no tile."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    archs = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
             dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
             dict(D=2, W=30, skips=(0,), i_embed=-1),
             dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
    with torch.no_grad():
        for i, kw in enumerate(archs):
            cfg = NeRFConfig(**kw)
            params = {k: v.detach() for k, v in NeRF(
                cfg, device=device,
                generator=torch.Generator().manual_seed(i)).params().items()}
            for S in (1, 7, 65):
                o, d, z, vd = rays_at(37, S, seed=i, device=device)
                vd = vd if cfg.use_viewdirs else None
                raw_p = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
                e3, ok3 = abs_err(fused_mlp.fused_nerf_forward_rays(
                    params, cfg, o, d, z, vd), raw_p, tol, fp32=True)
                mask = raw_p[:, -1, 3].abs() >= 1e-2
                got = fused_render.fused_render_rays(params, cfg, o, d, z, vd)
                want = fused_render.plain_render_rays(params, cfg, o, d, z, vd)
                checked = render_errs(got, want, mask, tol)
                e4 = max(e for e, _ in checked)
                log(f"  {kw} S={S}: B3 max err {e3:.1e}, B4 max err {e4:.1e} "
                    f"over {int(mask.sum())}/37 masked rays (tol {tol:g}; B3 and B4's "
                    f"rgb, acc, weights {FP32_TOL:g})")
                if not (ok3 and all(ok for _, ok in checked)):
                    raise AssertionError(f"kernels disagree at {kw} S={S}")


def check_render_repeats(device, params, cfg, tol, n=32768, runs=200):
    """B4 at S = 7 and 65 on n rays, ``runs`` times each: its tiles there
    hold the end of one ray and the start of the next, whose transmittance
    carry passes between tiles through shared memory. Every run's outputs
    (weights too) must be bit-identical to the first run's, and the first
    within tolerance of the plain version."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    with torch.no_grad():
        for S in (7, 65):
            o, d, z, vd = rays_at(n, S, seed=S, device=device)
            first = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                                   white_bkgd=True, want_weights=True)
            want = fused_render.plain_render_rays(params, cfg, o, d, z, vd,
                                                  white_bkgd=True)
            raw = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
            mask = raw[:, -1, 3].abs() >= 1e-2
            checked = render_errs(first, want, mask, tol)
            differ = 0
            for _ in range(runs - 1):
                got = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                                     white_bkgd=True, want_weights=True)
                differ += int(any(not torch.equal(g, f) for g, f in zip(got, first)))
            log(f"  B4 {n} rays S={S}: {runs} runs, {differ} not bit-identical to the "
                f"first; max err {max(e for e, _ in checked):.1e} over "
                f"{int(mask.sum())}/{n} masked rays")
            if differ or not all(ok for _, ok in checked):
                raise AssertionError(f"B4 at S={S}: {differ} of {runs} runs differ from "
                                     "the first, or the first disagrees with plain")


def mlp_case(kernel, label, cfg, params, n, S, err, tol, t, tp):
    """Log and record a B3 / B4 timing: t and tp are the kernel's and the
    plain version's (median, min, max) ms in turns."""
    (bms, by), (fms, fby) = mlp_bounds(cfg, params, n, S)
    verdict = ("beats" if t[2] < tp[1] else "loses to" if t[1] > tp[2] else "ties")
    log(f"{label}: max err {err:.3e} (tol {tol:g}, scaled by max(1, max|plain|)), "
        f"{spread(t)} ms vs plain {spread(tp)} ms ({verdict} it; median [min-max] of "
        f"10 samples in turns); bound {bms:.2f} ms split fp32 on the tensor cores "
        f"({by}), {fms:.2f} ms fp32 on the CUDA cores ({fby}); "
        f"{100 * bms / t[0]:.1f}% of the design's bound")
    return dict(kernel=kernel, S=S, n_rays=n, max_abs_err=err, ms=t[0], ms_min=t[1],
                ms_max=t[2], plain_ms=tp[0], plain_min=tp[1], plain_max=tp[2],
                bound_ms=bms, bound_by=by, bound_fp32_cuda_cores_ms=fms,
                vs_plain=verdict, design=TC_DESIGN)


def b3_case(label, params, cfg, rays, tol):
    """B3 on one ray block against its plain version (tol and FP32_TOL),
    timed in turns with it: its mlp_case."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp

    o, d, z, vd = rays
    n, S = z.shape
    with torch.no_grad():
        got = fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd)
        want = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
        torch.cuda.synchronize()
        err, ok = abs_err(got, want, tol, fp32=True)
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version "
                                 f"(max err {err:.3e}; tol {tol:g}, fp32 {FP32_TOL:g})")
        t, tp = in_turns(lambda: fused_mlp.fused_nerf_forward_rays(
            params, cfg, o, d, z, vd), lambda: fused_mlp.plain_nerf_forward_rays(
            params, cfg, o, d, z, vd), reps=3)
    return mlp_case("fused_mlp", label, cfg, params, n, S, err, tol, t, tp)


def b4_case(label, params, cfg, rays, tol, white_bkgd):
    """B4 on one ray block against its plain version over the rays clear of
    the 1e10 sentinel flip (at least 1 in 20 of them), timed in turns with
    it: its mlp_case."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    o, d, z, vd = rays
    n, S = z.shape
    with torch.no_grad():
        got = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                             white_bkgd=white_bkgd, want_weights=True)
        want = fused_render.plain_render_rays(params, cfg, o, d, z, vd,
                                              white_bkgd=white_bkgd)
        raw = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
        mask = raw[:, -1, 3].abs() >= 1e-2  # clear of the 1e10 sentinel flip
        checked = render_errs(got, want, mask, tol)
        errs = [e for e, _ in checked]
        log(f"{label}: {int(mask.sum())}/{n} masked rays (rgb, disp, acc, weights, "
            f"depth: {', '.join(f'{e:.1e}' for e in errs)}; tol {tol:g}, rgb, acc, "
            f"weights {FP32_TOL:g})")
        if not (all(ok for _, ok in checked) and int(mask.sum()) >= n // 20):
            raise AssertionError(f"{label} disagrees with its plain version")
        t, tp = in_turns(lambda: fused_render.fused_render_rays(
            params, cfg, o, d, z, vd, white_bkgd=white_bkgd, want_weights=False),
            lambda: fused_render.plain_render_rays(
                params, cfg, o, d, z, vd, white_bkgd=white_bkgd), reps=3)
    return mlp_case("fused_render", label, cfg, params, n, S, max(errs), tol, t, tp)


def phase_kernels(device, n=32768):
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    model = NeRF(cfg, device=device, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.params().items()}
    # fp32 sums over up to 283 terms in another order than cuBLAS, through
    # 10 layers; sin/cos see bit-identical arguments (see fused_mlp.py)
    tol = 2e-4
    cases = [b3_case(f"B3 fused_mlp S={S}", params, cfg,
                     lego_rays(n, S, seed=S, device=device), tol) for S in (64, 192)]
    cases.append(b4_case("B4 fused_render S=192", params, cfg,
                         lego_rays(n, 192, seed=7, device=device), tol, white_bkgd=True))
    # the fern recipe's fine pass (64 + 64 samples) on NDC rays, black
    # background (configs/fern.txt; phase 10's frames)
    fern = fern_rays(n, 128, seed=128, device=device)
    cases.append(b3_case("B3 fused_mlp S=128 (fern fine pass, NDC rays)", params, cfg,
                         fern, tol))
    cases.append(b4_case("B4 fused_render S=128 (fern fine pass, NDC rays)", params, cfg,
                         fern, tol, white_bkgd=False))

    check_other_shapes(device, tol)
    check_render_repeats(device, params, cfg, tol)

    # one gradient through each autograd.Function (backward recomputes
    # through the plain version) against autograd of the plain version
    o, d, z, vd = lego_rays(256, 64, seed=11, device=device)
    R = torch.randn(256, 64, 4, generator=torch.Generator().manual_seed(1)).to(device)

    def grad_o(fn):
        oo = o.clone().requires_grad_(True)
        fn(oo).backward()
        return oo.grad

    for name, f_kernel, f_plain in (
        ("fused_mlp", lambda oo: (fused_mlp.fused_nerf_forward_rays(
            params, cfg, oo, d, z, vd) * R).sum(),
         lambda oo: (fused_mlp.plain_nerf_forward_rays(
             params, cfg, oo, d, z, vd) * R).sum()),
        ("fused_render", lambda oo: sum(t.sum() for t in fused_render.fused_render_rays(
            params, cfg, oo, d, z, vd, white_bkgd=True)[:3]),
         lambda oo: sum(t.sum() for t in fused_render.plain_render_rays(
             params, cfg, oo, d, z, vd, white_bkgd=True)[:3])),
    ):
        gk, gp = grad_o(f_kernel), grad_o(f_plain)
        gerr, ok = abs_err(gk, gp, 1e-4)
        log(f"{name} gradient wrt rays_o: max err {gerr:.3e} (tol 1e-4, "
            "scaled by max(1, max|grad|))")
        if not ok:
            raise AssertionError(f"{name} gradient disagrees")
    return cases


def composite_inputs(n, S, seed, device, ndc=False):
    """Seeded composite inputs at a ray block's shape: raw [n, S, 4] ~ N(0, 2),
    depths and directions of lego_rays (S > 64: its sorted union), or with
    ``ndc`` of fern_rays."""
    import torch

    _, d, z, _ = (fern_rays if ndc else lego_rays)(n, max(S, 64), seed, device)
    if S < 64:
        z = z[:, torch.linspace(0, 63, S).round().long()].contiguous()
    elif S > 64:
        z = z[:, :S].contiguous()
    g = torch.Generator().manual_seed(seed)
    raw = (torch.randn(n, S, 4, generator=g) * 2).to(device)
    return raw, z, d


def _composite_errors(got, want):
    ab = {k: float((got[i] - want[i]).abs().max()) if got[i].numel() else 0.0
          for k, i in (("rgb", 0), ("acc", 2), ("weights", 3))}
    rel = {k: float(((got[i] - want[i]).abs() / want[i].abs().clamp(min=1e-12)).max())
           for k, i in (("disp", 1), ("depth", 4))}
    return ab, rel


def composite_check(label, raw, z, d, tol=1e-5):
    """B5 against its plain version on one input, with and without a white
    background: rgb, acc and weights within ``tol`` absolute, depth and
    disp within ``tol`` relative; returns the worst absolute error."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import composite

    worst = 0.0
    for wb in (False, True):
        with torch.no_grad():
            got = composite.composite_fused(raw, z, d, white_bkgd=wb)
            want = composite.plain_composite(raw, z, d, white_bkgd=wb)
        torch.cuda.synchronize()
        ab, rel = _composite_errors(got, want)
        log(f"  B5 {label} white_bkgd={wb}: abs {', '.join(f'{k} {v:.1e}' for k, v in ab.items())}; "
            f"rel {', '.join(f'{k} {v:.1e}' for k, v in rel.items())} (tol {tol:g})")
        if max(ab.values()) > tol or max(rel.values()) > tol:
            raise AssertionError(f"B5 disagrees with its plain version at {label}")
        worst = max(worst, *ab.values())
    return worst


def composite_case(n, S, what, device, ndc=False):
    """B5 at n rays x S samples (seeded inputs): checked by composite_check
    and timed beside its plain version and its bound; returns the case."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import composite

    raw, z, d = composite_inputs(n, S, seed=100 + S, device=device, ndc=ndc)
    err = composite_check(f"{n} rays S={S} ({what})", raw, z, d)
    # device time (queued_ms): a launch is shorter than the host's cost of
    # one call, which CUDA events around the call would measure; the
    # profiler, which timed this before, at times recorded none of it
    with torch.no_grad():
        ms = queued_ms(lambda: composite.composite_fused(raw, z, d, True))
        plain_ms = queued_ms(lambda: composite.plain_composite(raw, z, d, True))
        call_ms = time_ms(lambda: composite.composite_fused(raw, z, d, True), 20)
    t_bytes = composite.bytes_moved(n, S) / PEAK_BYTES
    t_ops = 40 * n * S / PEAK_FP32_FLOPS  # ~40 fp32 operations a sample
    bms, by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    log(f"B5 composite {n} rays S={S} ({what}): {ms:.4f} ms on the device ({call_ms:.4f} ms "
        f"a call by CUDA events), plain {plain_ms:.4f} ms on the device, bound {bms:.4f} ms "
        f"({by})")
    return dict(kernel="composite", S=S, n_rays=n, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, call_ms=call_ms, bound_ms=bms, bound_by=by)


def check_composite(device, n=32768):
    """B5 against its plain version (composite_check) at the main path's
    shapes and the odd ones, with its times and its gradient."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import composite

    cases = [composite_case(n, S, what, device, ndc=S == 128)
             for S, what in ((64, "coarse"), (192, "dense fine"), (48, "guided fine"),
                             (32, "froxel K"), (128, "fern fine, NDC rays"))]
    for S in (1, 21):
        raw, z, d = composite_inputs(37, S, seed=S, device=device)
        composite_check(f"37 rays S={S}", raw, z, d)
    R, S = 16, 24
    raw = torch.zeros(R, S, 4, device=device)
    raw[: R // 2, 0, 3] = 1e4       # opaque first sample
    raw[R // 2:, :, 3] = -100.0     # empty rays
    z = torch.linspace(2, 6, S, device=device).expand(R, S).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]], device=device).expand(R, 3).contiguous()
    composite_check("opaque and empty rays", raw, z, d)
    acc = composite.composite_fused(raw, z, d, white_bkgd=True)[2]
    if not (acc[: R // 2].min() > 0.999999 and acc[R // 2:].max() < 1e-6):
        raise AssertionError(f"B5 opaque / empty rays: acc {acc.tolist()}")

    # the gradient through the autograd.Function (remat through the plain
    # version) against autograd of the plain version
    raw, z, d = composite_inputs(256, 48, seed=5, device=device)
    g = torch.Generator().manual_seed(6)
    cot = [torch.randn(256, 3, generator=g).to(device),
           torch.randn(256, 48, generator=g).to(device)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (raw, z, d)]
        rgb, _, _, w, _ = fn(*leaves, white_bkgd=True)
        ((rgb * cot[0]).sum() + (w * cot[1]).sum()).backward()
        return [t.grad for t in leaves]

    gerr = max(rel_err(a, b) for a, b in zip(grads(composite.composite_fused),
                                             grads(composite.plain_composite)))
    log(f"B5 gradient wrt raw, z, rays_d: max err {gerr:.1e} of max|grad| (tol 1e-5)")
    if not gerr <= 1e-5:
        raise AssertionError("B5 gradient disagrees")
    return cases


def lego_points(n, S, seed, device, rays=None):
    """Points [n, S, 3] on seeded lego-like rays (or ``rays``' rays, e.g.
    fern_rays), their unit directions [n, 3] and a seeded cotangent g
    [n, S, 4] of the raw outputs."""
    import torch

    o, d, z, vd = (rays or lego_rays)(n, S, seed, device)
    z = z[:, :S]
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    g = torch.randn(n, S, 4, generator=torch.Generator().manual_seed(seed + 1))
    return pts, vd, g.to(device)


def rel_err(got, want):
    """max |got - want| / max(1e-12, max |want|)."""
    return float((got - want).abs().max()) / max(1e-12, float(want.abs().max()))


# A camera's gradient (a pose parameter's, a pose twist's) sums the
# per-point gradients of every ray with heavy cancellation: the plain fp32
# chain itself misses float64 there by 0.2-3% of max|grad| (phase 11 on an
# H100 80GB HBM3 at 700 W: screw, se(3) and twist gradients;
# tests/test_torch_pose_estimation.py holds the port's pose step to the JAX
# package's at 1e-5 on small nets), so two fp32 routes cannot agree to
# 1e-3. Such a gradient is held against
# the plain route in float64: the kernel route's error within the larger of
# 1e-3 and 3x the plain fp32 route's own error, each of max|grad|.
CAMERA_FLOOR, CAMERA_FACTOR = 1e-3, 3.0


@contextlib.contextmanager
def default_dtype(dtype):
    import torch

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def camera_held(got, plain, ref):
    """(error of ``got``, error of the fp32 ``plain``, both against the
    float64 ``ref`` relative to max|ref|, whether ``got`` is held)."""
    e_k, e_p = rel_err(got.double(), ref), rel_err(plain.double(), ref)
    return e_k, e_p, e_k <= max(CAMERA_FLOOR, CAMERA_FACTOR * e_p)


def bwd_bounds(cfg, params, n):
    """B2's two bounds on n points, ((ms, by) of the design, (ms, by) on
    the fp32 CUDA cores): operations, all of B2's FLOPs (the tile kernel's
    input gradients, one forward's worth, and the dW products' one) x 3 TF32
    products over the TF32 peak for the design, all of them over the fp32
    peak for the other; vs the bytes of the function (points, directions,
    cotangent and weights in; dx and the gradients out). The H and dZ
    buffers (19,856 bytes a point at the lego width) are the design's own
    traffic, not the function's, and overlap the arithmetic of both
    kernels (B1's training launch writes H, 10,096 bytes a point)."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import network_bytes
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import flops_per_point_bwd

    total = flops_per_point_bwd(cfg) * n
    nbytes = 4 * (n * 3 + n * 4 + n * 6) + 2 * network_bytes(params, cfg)
    t_bytes = nbytes / PEAK_BYTES
    out = []
    for t_ops in (3 * total / PEAK_TF32_FLOPS, total / PEAK_FP32_FLOPS):
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return tuple(out)


def kernels_ms(fn, reps, names):
    """Device ms per call of ``fn`` of each CUDA kernel whose name holds one
    of ``names``, under torch.profiler over ``reps`` calls after a warm-up;
    None for a name no kernel launched (a parent tree's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: 0.0 for k in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in names:
                if k in e.name:
                    us[k] += e.time_range.elapsed_us()
    return {k: (v / 1e3 / reps if v > 0 else None) for k, v in us.items()}


def check_b2_repeats(params, cfg, pts, vd, g, runs=20):
    """B2 ``runs`` times on one input: every gradient, dpts and ddirs bit-
    identical to the first run (no atomics, fixed-order sums)."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp_bwd

    def flat(out):
        grads, dpts, ddirs = out
        return [grads[k] for k in sorted(grads)] + [dpts] + (
            [ddirs] if ddirs is not None else [])

    first = flat(fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g))
    differ = 0
    for _ in range(runs - 1):
        got = flat(fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g))
        differ += int(not all(torch.equal(a, b) for a, b in zip(got, first)))
    torch.cuda.synchronize()
    log(f"B2 {runs} runs at N={pts.numel() // 3}: {differ} differ from the first "
        "(bit for bit)")
    if differ:
        raise AssertionError(f"B2: {differ} of {runs} runs differ from the first")
    return runs - differ


def relu_masks(cfg, hbuf, n_pad, n):
    """B2's ReLU decisions, read from the H buffer its tile kernel read
    (fused_mlp_bwd.launch_backward_h; act_layout's segments): h_l > 0
    [n, W] for every trunk layer, then hv > 0 [n, W // 2] with viewdirs."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import H_HV, act_layout

    hseg, _, _, _ = act_layout(cfg)

    def on(slot, width):
        off, ld = (int(v) for v in hseg[slot])
        return hbuf[off * n_pad:(off + ld) * n_pad].reshape(n_pad, ld)[:n, :width] > 0

    masks = [on(1 + i, cfg.W) for i in range(cfg.D)]
    if cfg.use_viewdirs:
        masks.append(on(H_HV, cfg.W // 2))
    return masks


def masked_mlp(params, cfg, emb, masks):
    """The MLP (models.nerf.apply_mlp) on embeddings [N, P (+ V)] with its
    ReLU decisions given: ``masks`` (relu_masks) in place of each ReLU's
    own test, a unit on where its mask is -> raw [N, C]."""
    import torch
    import torch.nn.functional as F

    P = cfg.input_ch

    def dense(name, x):
        return F.linear(x, params[name + ".weight"], params[name + ".bias"])

    h = emb[:, :P]
    for i in range(cfg.D):
        h = dense(f"pts_linears.{i}", h) * masks[i]
        if i in cfg.skips:
            h = torch.cat([emb[:, :P], h], -1)
    if cfg.use_viewdirs:
        feature = dense("feature_linear", h)
        hv = dense("views_linears.0", torch.cat([feature, emb[:, P:]], -1)) * masks[-1]
        return torch.cat([dense("rgb_linear", hv), dense("alpha_linear", h)], -1)
    return dense("output_linear", h)


def masked_backward(params, cfg, pts, viewdirs, g, masks):
    """fused_mlp_bwd.plain_mlp_backward on the ReLU decisions ``masks``:
    autograd of masked_mlp -> (grads, dpts, ddirs)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import embed_inputs, torch_param_order

    names = torch_param_order(cfg)
    with torch.enable_grad():
        w = [params[k].detach().requires_grad_(True) for k in names]
        pt = pts.detach().requires_grad_(True)
        vd = None if viewdirs is None else viewdirs.detach().requires_grad_(True)
        emb = embed_inputs(cfg, pt, vd)
        raw = masked_mlp(dict(zip(names, w)), cfg, emb.reshape(-1, emb.shape[-1]), masks)
        ins = w + [pt] + ([vd] if vd is not None else [])
        gs = torch.autograd.grad(raw.reshape(g.shape), ins, g)
    n = len(names)
    return dict(zip(names, gs[:n])), gs[n], (gs[n + 1] if vd is not None else None)


def masked_backward_bf16(params, cfg, pts, viewdirs, g, masks):
    """fused_mlp_bwd.plain_mlp_backward_bf16 (the same roundings, line for
    line) on the ReLU decisions ``masks`` -> (grads, dpts, ddirs)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import embed_inputs, torch_param_order
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import bf16_round
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import param_names_linear

    P, V, W = cfg.input_ch, cfg.input_ch_views, cfg.W
    C = g.shape[-1]
    with torch.enable_grad():
        pt = pts.detach().requires_grad_(True)
        vd = None if viewdirs is None else viewdirs.detach().requires_grad_(True)
        emb32 = embed_inputs(cfg, pt, vd)
    e = bf16_round(emb32.detach().reshape(-1, P + V))
    wt = {k: bf16_round(params[k + ".weight"]) for k in param_names_linear(cfg)}
    b = {k: params[k + ".bias"] for k in param_names_linear(cfg)}
    grads = {}

    def dense_grads(name, dz, dz_c, x):
        grads[name + ".weight"] = dz_c.t() @ x
        grads[name + ".bias"] = dz.sum(0)

    ins, hs, x = [], [], e[:, :P]
    for i in range(cfg.D):
        name = f"pts_linears.{i}"
        ins.append(x)
        hs.append(bf16_round((x @ wt[name].t() + b[name]) * masks[i]))
        x = torch.cat([e[:, :P], hs[-1]], -1) if i in cfg.skips else hs[-1]
    h = hs[-1]
    gc = bf16_round(g.reshape(-1, C))
    demb = torch.zeros_like(e)
    if cfg.use_viewdirs:
        feature = bf16_round(h @ wt["feature_linear"].t() + b["feature_linear"])
        vin = torch.cat([feature, e[:, P:P + V]], -1)
        hv = bf16_round((vin @ wt["views_linears.0"].t() + b["views_linears.0"]) * masks[-1])
        g_rgb, g_alpha = gc[:, :3], gc[:, 3:4]
        dense_grads("rgb_linear", g_rgb, g_rgb, hv)
        dense_grads("alpha_linear", g_alpha, g_alpha, h)
        dhv = (g_rgb @ wt["rgb_linear"]) * masks[-1]
        dhv_c = bf16_round(dhv)
        dense_grads("views_linears.0", dhv, dhv_c, vin)
        dvin = dhv_c @ wt["views_linears.0"]
        demb[:, P:P + V] += dvin[:, W:]
        dfeature = dvin[:, :W]
        dfeature_c = bf16_round(dfeature)
        dense_grads("feature_linear", dfeature, dfeature_c, h)
        dh = g_alpha @ wt["alpha_linear"] + dfeature_c @ wt["feature_linear"]
    else:
        dense_grads("output_linear", gc, gc, h)
        dh = gc @ wt["output_linear"]
    for i in reversed(range(cfg.D)):
        name = f"pts_linears.{i}"
        dz = dh * masks[i]
        dz_c = bf16_round(dz)
        dense_grads(name, dz, dz_c, ins[i])
        dx_in = dz_c @ wt[name]
        if i == 0:
            demb[:, :P] += dx_in
        elif (i - 1) in cfg.skips:
            demb[:, :P] += dx_in[:, :P]
            dh = dx_in[:, P:]
        else:
            dh = dx_in
    d_in = torch.autograd.grad(emb32, [pt] + ([vd] if vd is not None else []),
                               demb.reshape(emb32.shape))
    grads = {k: grads[k] for k in torch_param_order(cfg)}
    return grads, d_in[0], (d_in[1] if vd is not None else None)


def relu_switches(cfg, params, pts, vd, masks, bf16=False):
    """Where B2's ReLU decisions (``masks``, relu_masks of its H) differ
    from the plain forward's own (float64; under ``bf16`` the plain bf16
    forward's roundings): (count, the largest |pre-activation| among them
    as a share of its layer's max|pre-activation|)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import embed_inputs
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import bf16_round

    dt = torch.float32 if bf16 else torch.float64
    rnd = bf16_round if bf16 else (lambda a: a)
    P, n = cfg.input_ch, pts.numel() // 3
    emb = embed_inputs(cfg, pts.to(dt), None if vd is None else vd.to(dt)).reshape(n, -1)
    e = rnd(emb)

    def dense(name, x):
        return rnd(x) @ rnd(params[name + ".weight"].to(dt)).t() + params[name + ".bias"].to(dt)

    zs, x = [], e[:, :P]
    for i in range(cfg.D):
        zs.append(dense(f"pts_linears.{i}", x))
        h = rnd(torch.relu(zs[-1]))
        x = torch.cat([e[:, :P], h], -1) if i in cfg.skips else h
    if cfg.use_viewdirs:
        feature = rnd(dense("feature_linear", x))
        zs.append(dense("views_linears.0", torch.cat([feature, e[:, P:]], -1)))
    count, worst = 0, 0.0
    for z, m in zip(zs, masks):
        d = (z > 0) != m
        count += int(d.sum())
        if d.any():
            worst = max(worst, float(z[d].abs().max() / z.abs().max()))
    return count, worst


def check_train_kernels(cfg, params, pts, vd, g, tol_fwd, tol_bwd, label):
    """B1 and B2 against their plain versions on one input, B1 also within
    FP32_TOL; returns (B1 max abs err, B2 max abs err, B2 errors by tensor
    relative to max |grad|). B2 is held on its own ReLU decisions: against
    the plain version in float64 with its masks (relu_masks, masked_backward),
    each of its decisions required to be the float64 forward's but at
    pre-activations within RELU_SWITCH of 0; it is also logged against
    the plain fp32 route and that route against float64."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    with torch.no_grad():
        e1, ok1 = abs_err(fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                          apply_nerf(params, cfg, pts, vd), tol_fwd, fp32=True)
    want = fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, vd, g)
    p64 = {k: v.double() for k, v in params.items()}
    args64 = (pts.double(), None if vd is None else vd.double(), g.double())
    own = fused_mlp_bwd.plain_mlp_backward(p64, cfg, *args64)
    *got, hbuf, n_pad = fused_mlp_bwd.launch_backward_h(params, cfg, pts, vd, g)
    masks = relu_masks(cfg, hbuf, n_pad, pts.numel() // 3)
    del hbuf
    ref = masked_backward(p64, cfg, *args64, masks)
    torch.cuda.synchronize()
    names = list(want[0]) + ["dpts"] + (["ddirs"] if vd is not None else [])

    def flat(out):
        return [out[0][k] for k in want[0]] + [out[1]] + ([out[2]] if vd is not None else [])

    errs = {k: rel_err(a.double(), r) for k, a, r in zip(names, flat(got), flat(ref))}
    e2 = max(float((a.double() - r).abs().max()) for a, r in zip(flat(got), flat(ref)))
    worst = max(errs, key=errs.get)
    vs_plain = {k: rel_err(a, b) for k, a, b in zip(names, flat(got), flat(want))}
    plain_own = {k: rel_err(b.double(), r) for k, b, r in zip(names, flat(want), flat(own))}
    switches, z_worst = relu_switches(cfg, p64, pts, vd, masks)
    del ref, own
    log(f"  {label}: B1 max err {e1:.1e} (tol {tol_fwd:g}, fp32 {FP32_TOL:g}, "
        f"x max(1, max|plain|)); "
        f"B2 on its ReLU decisions vs the plain version in float64: max abs err {e2:.1e}, "
        f"worst {worst} {errs[worst]:.1e} of its max|grad| (tol {tol_bwd:g}) over "
        f"{len(errs)} tensors; {switches} decisions other than float64's, all at "
        f"|pre-activation| <= {z_worst:.1e} of the layer's max (tol {RELU_SWITCH:g}); "
        f"vs the plain fp32 route worst {max(vs_plain, key=vs_plain.get)} "
        f"{max(vs_plain.values()):.1e}, that route vs float64 worst "
        f"{max(plain_own, key=plain_own.get)} {max(plain_own.values()):.1e}")
    if not ok1:
        raise AssertionError(f"B1 disagrees with its plain version at {label}")
    if not (errs[worst] <= tol_bwd and z_worst <= RELU_SWITCH):
        raise AssertionError(f"B2 disagrees with its plain version at {label}: {errs}, "
                             f"ReLU decisions switched up to {z_worst:.1e}")
    return e1, e2, errs


def train_kernel_cases(cfg, params, n_rays, S, rays, what, device, tol_fwd, tol_bwd,
                       repeats=False):
    """B1 and B2 on n_rays x S seeded points of ``rays``: checked by
    check_train_kernels, timed in turns with the plain chain beside both
    bounds, B2's kernels under the profiler, their packs' ms; ``repeats``
    also runs B2 20 times for bit-identical results. Returns the two cases."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    cases = []
    pts, vd, g = lego_points(n_rays, S, seed=S, device=device, rays=rays)
    e1, e2, errs = check_train_kernels(cfg, params, pts, vd, g, tol_fwd, tol_bwd,
                                       f"{what} N={n_rays * S} S={S}")
    with torch.no_grad():
        t1, tp1 = in_turns(lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                           lambda: apply_nerf(params, cfg, pts, vd), reps=10)
        pack_ms = time_ms(lambda: fused_mlp.pack_network_tc(params, cfg, pts.device), 5)
        packs = (fused_mlp.pack_network_tc, fused_mlp_bwd.pack_backward_tc)
        pack2_ms = time_ms(lambda: [f(params, cfg, pts.device) for f in packs], 5)
    # B1's training launch (it writes H) timed on its own; B2 over that H,
    # made outside the timed calls, with dx (a pose step) and without (a
    # step whose points need no gradient: nerf_bwd_kernel<false>)
    with torch.no_grad():
        t1h = time_ms(lambda: fused_mlp_bwd.forward_saving_h(params, cfg, pts, vd), 5)
    saved = fused_mlp_bwd.forward_saving_h(params, cfg, pts, vd)[1]

    def b2(dx=True):
        return fused_mlp_bwd.launch_backward(params, cfg, pts, vd, g, saved=saved, dx=dx)

    t2, tp2 = in_turns(b2, lambda: fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, vd, g),
                       reps=5)
    names = ("nerf_bwd_kernel", "nerf_dw_kernel", "grad_reduce_kernel")
    parts = kernels_ms(b2, 3, names)
    tile_nodx = kernels_ms(lambda: b2(dx=False), 3, names[:1])["nerf_bwd_kernel"]
    del saved
    (b1, by1), (f1, fby1) = points_bounds(cfg, params, n_rays, S)
    (b2b, by2), (f2, fby2) = bwd_bounds(cfg, params, n_rays * S)
    verdict = "beats" if t1[2] < tp1[1] else "loses to" if t1[1] > tp1[2] else "ties"
    verdict2 = "beats" if t2[2] < tp2[1] else "loses to" if t2[1] > tp2[2] else "ties"
    log(f"B1 fused_mlp points N={n_rays * S}: {spread(t1)} ms vs plain {spread(tp1)} ms "
        f"({verdict} it; median [min-max] of 10 samples in turns); bound "
        f"{b1:.2f} ms split fp32 on the tensor cores ({by1}), {f1:.2f} ms fp32 on "
        f"the CUDA cores ({fby1}); {100 * b1 / t1[0]:.1f}% of the design's bound; "
        f"its weight pack (pack_network_tc) {pack_ms:.3f} ms a call; its training "
        f"launch (nerf_points_tc_kernel<true>, writing H) {t1h:.4f} ms")

    def fmt(v):
        return "absent" if v is None else f"{v:.4f}"

    log(f"B2 fused_mlp_bwd N={n_rays * S}: {spread(t2)} ms over B1's saved H vs plain "
        f"{spread(tp2)} ms (its own forward included; {verdict2} it; median [min-max] of 10 "
        f"samples in turns); device ms by kernel (profiler, 3 calls): nerf_bwd_kernel "
        f"(tile) {fmt(parts['nerf_bwd_kernel'])}, without dx {fmt(tile_nodx)}, "
        f"nerf_dw_kernel {fmt(parts['nerf_dw_kernel'])}, grad_reduce_kernel "
        f"{fmt(parts['grad_reduce_kernel'])}; bound {b2b:.2f} ms "
        f"design (all FLOPs split fp32 on the tensor cores; {by2}; the H and dZ "
        f"traffic overlaps both), {f2:.2f} ms fp32 "
        f"on the CUDA cores ({fby2}); {100 * b2b / t2[0]:.1f}% of the design's bound; "
        f"its packs ({' + '.join(f.__name__ for f in packs)}) {pack2_ms:.3f} ms a call")
    cases.append(dict(kernel="fused_mlp_points", S=S, n_points=n_rays * S,
                      max_abs_err=e1, ms=t1[0], ms_min=t1[1], ms_max=t1[2],
                      plain_ms=tp1[0], plain_min=tp1[1], plain_max=tp1[2],
                      bound_ms=b1, bound_by=by1, bound_fp32_cuda_cores_ms=f1,
                      vs_plain=verdict, pack_ms=pack_ms, train_ms=t1h, design=B1_DESIGN))
    b2_case = dict(kernel="fused_mlp_bwd", S=S, n_points=n_rays * S,
                   max_abs_err=e2, max_rel_err=max(errs.values()), ms=t2[0],
                   ms_min=t2[1], ms_max=t2[2], plain_ms=tp2[0], plain_min=tp2[1],
                   plain_max=tp2[2], bound_ms=b2b, bound_by=by2,
                   bound_fp32_cuda_cores_ms=f2, vs_plain=verdict2,
                   tile_ms=parts["nerf_bwd_kernel"], tile_nodx_ms=tile_nodx,
                   dw_ms=parts["nerf_dw_kernel"], reduce_ms=parts["grad_reduce_kernel"],
                   pack_ms=pack2_ms, design=B2_DESIGN)
    if repeats:
        b2_case["identical_runs"] = check_b2_repeats(params, cfg, pts, vd, g)
    cases.append(b2_case)
    return cases


def phase_train_kernels(device):
    """Phase 5: B1 and B2 at both training shapes of the lego recipe and at
    the odd shapes, with times."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=device, generator=torch.Generator().manual_seed(5)).params().items()}
    # B1: as B3 (fp32 sums over <= 283 terms in another order than cuBLAS;
    # split fp32 on the tensor cores, so also FP32_TOL).
    # B2: each gradient sums up to 196,608 per-point products in another
    # order than cuBLAS (split fp32 on the tensor cores in k8 slices over
    # point ranges, then a fixed-order sum over the ranges): the error is
    # held relative to max |grad| per tensor
    tol_fwd, tol_bwd = 2e-4, 1e-3
    cases = []
    # both passes of the lego recipe (64 + 128 samples) and the fern recipe's
    # fine pass (64 + 64) on NDC rays
    for S, rays, what in ((64, lego_rays, "lego"), (192, lego_rays, "lego"),
                          (128, fern_rays, "fern, NDC rays")):
        cases += train_kernel_cases(cfg, params, 1024, S, rays, what, device, tol_fwd,
                                    tol_bwd, repeats=S == 192)
    archs = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
             dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
             dict(D=2, W=30, skips=(0,), i_embed=-1),
             dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
    for i, kw in enumerate(archs):
        acfg = NeRFConfig(**kw)
        ap = {k: v.detach() for k, v in NeRF(
            acfg, device=device, generator=torch.Generator().manual_seed(i)).params().items()}
        for n_rays, S in ((37, 7), (300, 65)):
            pts, vd, g = lego_points(n_rays, S, seed=10 + i, device=device)
            vd = vd if acfg.use_viewdirs else None
            g = g[..., :fused_mlp.out_channels(acfg)].contiguous() if acfg.use_viewdirs \
                else torch.cat([g, g[..., :1]], -1).contiguous()
            check_train_kernels(acfg, ap, pts, vd, g, tol_fwd, tol_bwd,
                                f"{kw} N={n_rays * S}")
    return cases, {recipe: check_train_step(device, recipe) for recipe in ("lego", "fern")}


def train_step_setup(device, fused, recipe="lego", precision="fp32", world=None):
    """A training step of ``recipe`` on a seeded state: (state, step_fn,
    images, poses, overrides). "lego": two 400x400 seeded images, 64 + 128
    samples per ray, N_rand 1024 inside the precrop window of the
    single-image sampler; the stratified jitter and inverse-CDF draws are
    pinned. "fern" (configs/fern.txt): two 378x504 seeded images of
    forward-facing cameras, the batching sampler, NDC rays, 64 + 64
    samples, black background, sigma noise 1.0, its draws pinned too.
    "refine": the lego step with --refine_poses, --appearance and
    --barf_anneal: the state at step 600, past --refine_poses_from 500 and
    mid-ramp of BARF over [0, 1200], its pixels pinned to image 1 (image 0
    is the anchor) through ``draws``, the sixth item (None otherwise).
    ``precision`` is the render config's ("bf16": the bf16 kernels, or
    apply_nerf in bf16 on the plain path); ``world`` makes the step
    data-parallel (phase 16)."""
    import numpy as np
    import torch

    from nerf_shared_tpu_torch.data.poses import pose_spherical
    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4, output_ch=5)
    g = torch.Generator().manual_seed(21)
    if recipe in ("lego", "refine"):
        H = W = 400
        focal = 0.5 * H / math.tan(0.5 * 0.6911112)
        poses = [pose_spherical(a, -30.0, 4.0) for a in (0.0, 120.0)]
        spec_kw = dict(single_image=True, precrop_iters=500, precrop_frac=0.5)
        rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64,
                            use_viewdirs=True, white_bkgd=True, near=2.0, far=6.0,
                            fused_backward=fused, precision=precision)
    else:
        H, W, focal = FERN_H, FERN_W, FERN_FOCAL
        poses = [np.eye(4), np.eye(4)]
        poses[1][:3, 3] = [0.1, -0.05, 0.02]
        spec_kw = dict(single_image=False)
        rcfg = RenderConfig(perturb=1.0, N_importance=64, N_samples=64,
                            use_viewdirs=True, white_bkgd=False, ndc=True, near=0.0,
                            far=1.0, raw_noise_std=1.0, fused_backward=fused,
                            precision=precision)
    K = [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]]
    images = torch.rand(2, H, W, 3, generator=g).to(device)
    poses = torch.stack([torch.as_tensor(p[:3, :4]) for p in poses]).float().to(device)
    spec = PixelSamplerSpec.from_K(H, W, K, 1024, **spec_kw)
    S, Si = rcfg.N_samples, rcfg.N_importance
    overrides = {"t_rand": torch.rand(1024, S, generator=g),
                 "u": torch.rand(1024, Si, generator=g)}
    if rcfg.raw_noise_std > 0:
        overrides["noise_coarse"] = torch.randn(1024, S, generator=g)
        overrides["noise_fine"] = torch.randn(1024, S + Si, generator=g)
    overrides = {k: v.to(device) for k, v in overrides.items()}
    if recipe != "refine":
        state = create_train_state(cfg, cfg, device, seed=3, lrate=5e-4, lrate_decay=500)
        return (state, make_train_step(rcfg, cfg, cfg, spec, world=world), images, poses,
                overrides, None)
    state = create_train_state(cfg, cfg, device, seed=3, lrate=5e-4, lrate_decay=500,
                               n_refine_poses=2, n_appearance=2)
    state.step = 600
    draws = {"img_idx": 1, "key_y": torch.randint(0, 1 << 32, (2,), generator=g),
             "key_x": torch.randint(0, 1 << 32, (2,), generator=g)}
    step = make_train_step(rcfg, cfg, cfg, spec, pose_start=500, barf_end=1200)
    return state, step, images, poses, overrides, draws


def adam_checks(k, p):
    """The post-Adam parameters of one step from equal states through the
    kernels (``k``) and the plain path (``p``): dicts of "params", "grads"
    and "lrs" (each parameter's group rate). Adam's first update is
    u(g) = lr * g / (|g| + eps) (m and v start at zero), so three checks:
    - everywhere they differ by u(g_plain) - u(g_kernel), to fp32 rounding
      (adam_err);
    - where |g_plain| is over 100 eps and over 100 |g_kernel - g_plain|,
      that difference is below lr * 1e-4, so they agree to 1e-6 outright
      (param_err, at the field's lr 5e-4; 2e-6 at the pose and appearance
      groups' 1e-3);
    - the entries that moved apart by more than 1e-6 (|g| near eps, or a
      sign flip of a gradient near 0) are at most 1 in 100: 307 and 1,656
      of 1,191,688 in two runs on the H100, so a wholesale flip of the
      small gradients fails while the run-to-run spread passes.
    Returns (param_err, adam_err, moved, moved_tol, moved_g, n_sure, n_par),
    moved_g the largest |grad| among the moved entries over its tensor's
    max."""
    eps = 1e-8
    n_par, n_sure, moved, adam_err, param_err, moved_g = 0, 0, 0, 0.0, 0.0, 0.0
    for pk, pp, gk, gp, lr in zip(k["params"], p["params"], k["grads"], p["grads"],
                                  k["lrs"]):
        du = lr * gp / (gp.abs() + eps) - lr * gk / (gk.abs() + eps)
        adam_err = max(adam_err, float(((pk - pp) - du).abs().max()))
        far = du.abs() > 1e-6
        moved += int(far.sum())
        if bool(far.any()):
            moved_g = max(moved_g, float(gp[far].abs().max() / gp.abs().max()))
        sure = (gp.abs() > 100 * eps) & (gp.abs() > 100 * (gk - gp).abs())
        if bool(sure.any()):
            param_err = max(param_err, float((pk - pp)[sure].abs().max()) * 5e-4 / lr)
        n_sure += int(sure.sum())
        n_par += gp.numel()
    return param_err, adam_err, moved, n_par // 100, moved_g, n_sure, n_par


def check_train_step(device, recipe="lego"):
    """One training step of ``recipe`` (train_step_setup) through B1 + B2
    and through the plain path from the same state and draws; returns the
    step times (ms, median of 3 after one warm-up step each) and the
    errors. Under "refine" the pose twists and appearance gains and offsets
    are held with the fields, each at its own group's rate."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    out = {}
    dec = ReluDecisions()
    for fused in (True, False):
        state, step, images, poses, ov, draws = train_step_setup(device, fused, recipe)
        params = state.parameters() + list(state.aux.values())
        before = (fused_mlp.POINT_LAUNCHES, fused_mlp_bwd.LAUNCHES, fused_mlp.SAVED_H_POINTS)
        with dec.record() if fused else dec.replay():
            aux = step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                       overrides=ov)
        torch.cuda.synchronize()
        launched = (fused_mlp.POINT_LAUNCHES - before[0], fused_mlp_bwd.LAUNCHES - before[1])
        out[fused] = dict(loss=float(aux["loss"]), launched=launched,
                          saved_h=fused_mlp.SAVED_H_POINTS - before[2],
                          grads=[p.grad.detach().clone() for p in params],
                          params=[p.detach().clone() for p in params],
                          lrs=[g["lr"] for g in state.optimizer.param_groups
                               for _ in g["params"]])

        def again():
            step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                 overrides=ov)

        out[fused]["ms"] = time_ms(again, 3)
    k, p = out[True], out[False]
    if k["launched"] != (2, 2) or p["launched"] != (0, 0):
        raise AssertionError(f"step launches: kernels {k['launched']}, plain {p['launched']}")
    # B1's training launches wrote H for every point of both passes
    step_points = 1024 * (64 + (64 + 64 if recipe == "fern" else 64 + 128))
    if k["saved_h"] != step_points or p["saved_h"] != 0:
        raise AssertionError(f"step H points: kernels {k['saved_h']} (want {step_points}), "
                             f"plain {p['saved_h']}")
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    # the pose twists and appearance gains (after the fields) are camera
    # gradients: held against the plain step in float64 (camera_held)
    n_aux = 0
    aux_note, aux_ok = "", True
    if recipe == "refine":
        state, step, images, poses, ov, draws = train_step_setup(device, False, recipe)
        with default_dtype(torch.float64):
            for _, m in state.branches():
                m.double()
            for t in state.aux.values():
                t.data = t.data.double()
            step(state, images.double(), poses.double(), torch.Generator().manual_seed(9),
                 draws=draws, overrides={kk: v.double() for kk, v in ov.items()})
        names = list(state.aux)
        n_aux = len(names)
        held = {n: camera_held(gk, gp, t.grad) for n, gk, gp, t in zip(
            names, k["grads"][-n_aux:], p["grads"][-n_aux:], state.aux.values())}
        aux_ok = all(ok for _, _, ok in held.values()) and all(
            float(t.grad.abs().max()) > 0 for t in state.aux.values())
        aux_note = ("; against the plain step in float64: " + ", ".join(
            f"{n} {e_k:.1e} (plain fp32 {e_p:.1e})" for n, (e_k, e_p, _) in held.items())
            + f" of max|grad| (tol max({CAMERA_FLOOR:g}, {CAMERA_FACTOR:g} x plain fp32's))")
    n_fields = len(k["grads"]) - n_aux
    grad_err = max(rel_err(a, b) for a, b in zip(k["grads"][:n_fields], p["grads"][:n_fields]))
    param_err, adam_err, moved, moved_tol, moved_g, n_sure, n_par = adam_checks(k, p)
    what = {"lego": "64 + 128 samples",
            "fern": "64 + 64 samples, NDC, batching, sigma noise 1.0 pinned",
            "refine": "64 + 128 samples, pose twists + appearance + BARF at progress 0.5"
            }[recipe]
    log(f"train step {recipe} (N_rand 1024, {what}): kernels {k['ms']:.2f} ms, plain "
        f"{p['ms']:.2f} ms; 2 B1 + 2 B2, H of {k['saved_h']:,} points; loss rel err {loss_err:.1e} (tol 1e-5), worst field gradient "
        f"{grad_err:.1e} of max|grad| (tol 1e-3){dec.note()}{aux_note}; post-Adam params: "
        f"{param_err:.1e} "
        f"apart (at lr 5e-4) on the {n_sure} of {n_par} entries whose gradient dwarfs eps "
        f"and the gradient difference (tol 1e-6), {adam_err:.1e} from Adam's update of the "
        f"two gradients everywhere (tol 1e-6), {moved} entries moved apart by more "
        f"than 1e-6 (tol {moved_tol}), the largest |grad| among them {moved_g:.1e} "
        "of its tensor's max")
    if not (loss_err <= 1e-5 and grad_err <= 1e-3 and param_err <= 1e-6
            and adam_err <= 1e-6 and moved <= moved_tol and aux_ok):
        raise AssertionError(f"the kernel training step ({recipe}) disagrees with the "
                             "plain step")
    return {"kernel_ms": k["ms"], "plain_ms": p["ms"], "saved_h_points": k["saved_h"],
            "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "param_err": param_err, "adam_err": adam_err,
            "moved": moved, "moved_tol": moved_tol, "moved_max_grad": moved_g,
            "sure": n_sure, "n_params": n_par}


def _render_view(job):
    """One RGBA view of the hard scene, written as a PNG (pool worker)."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene
    from nerf_shared_tpu_torch.data.images import imwrite_u8

    path, pose, size, focal = job
    rgba = hard_scene.render_gt_rgba(np.asarray(pose), size, size, focal)
    imwrite_u8(path, (np.clip(rgba, 0, 1) * 255).astype(np.uint8))


def write_train_scene(root, size=800, n_train=24, n_val=2, n_test=2, workers=8):
    """A 3-D-consistent blender-format scene: benchmarks/hard_scene.py's
    textured sphere and rods, seen from a radius-4 orbit at heights 12-50
    degrees, near 2, far 6; views rendered in a spawn-context pool."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene

    n = n_train + n_val + n_test
    rng = np.random.default_rng(11)
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        phi = np.deg2rad(12.0 + 38.0 * rng.random())
        eye = 4.0 * np.array([np.cos(phi) * np.sin(th), np.sin(phi),
                              np.cos(phi) * np.cos(th)])
        poses.append(hard_scene._look_at(eye))
    focal = 1.1 * size
    order = np.random.default_rng(5).permutation(n)
    splits = {"train": order[:n_train], "val": order[n_train:n_train + n_val],
              "test": order[n_train + n_val:]}
    jobs = []
    for split, idxs in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            rel = f"{split}/r_{j}"
            jobs.append((os.path.join(root, rel + ".png"), poses[i].tolist(), size, focal))
            pose = np.eye(4)
            pose[:3] = poses[i]
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * size / focal)),
                       "near": hard_scene.NEAR, "far": hard_scene.FAR,
                       "frames": frames}, f)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_render_view, jobs)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def capture(fn):
    """(fn(), its stdout), the stdout still printed."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn()
    return result, tee.buf.getvalue()


def run_train_cli(argv):
    """apps.train.main(argv) with its stdout kept -> (result, text)."""
    from nerf_shared_tpu_torch.apps import train

    return capture(lambda: train.main(argv))


def phase_training(device, steps=600, more=200):
    """Phase 6: train, resume and render_only through the CLI."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp
    from nerf_shared_tpu_torch.train.state import lr_at

    scene, logs = os.path.join(WORK, "train_scene"), os.path.join(WORK, "train_logs")
    t0 = time.perf_counter()
    write_train_scene(scene)
    log(f"phase 6: wrote the 28-view 800x800 scene in {time.perf_counter() - t0:.1f} s")
    base = ["--config", os.path.join(REPO, "configs", "lego.txt"), "--datadir", scene,
            "--basedir", logs, "--expname", "lego_smoke", "--device", device,
            "--testskip", "1", "--i_print", "50", "--i_testset", "0",
            "--i_video", "0", "--i_img", "200", "--i_weights", str(steps)]

    zero_counts()
    t0 = time.perf_counter()
    state, text = run_train_cli(base + ["--N_iters", str(steps)])
    first_wall = time.perf_counter() - t0
    state2, text2 = run_train_cli(base + ["--N_iters", str(steps + more)])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    zero_counts()
    _, text3 = run_train_cli(base + ["--N_iters", str(steps + more), "--render_only",
                                     "--render_test"])
    render_launches = {"fused_mlp": fused_mlp.LAUNCHES, "composite": composite.LAUNCHES}

    total = steps + more
    if launches["fused_mlp_points"] != 2 * total or launches["fused_mlp_bwd"] != 2 * total:
        raise AssertionError(f"expected B1 and B2 launched {2 * total} times: {launches}")
    train_lines = re.findall(r"\[TRAIN\] Iter: (\d+) Loss: \S+\s+PSNR: (\S+)\s+rays/sec: (\S+)",
                             text + text2)
    psnrs = [float(p) for _, p, _ in train_lines]
    rps = [float(r.replace(",", "")) for _, _, r in train_lines]
    vals = re.findall(r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+) SSIM: (\S+)", text + text2)
    if "Reloading from" not in text2:
        raise AssertionError("the resumed run did not reload its checkpoint")
    if state2.count != total or state2.step != total:
        raise AssertionError(f"resume: Adam count {state2.count}, step {state2.step}, "
                             f"expected {total}")
    lr = state2.optimizer.param_groups[0]["lr"]
    if abs(lr - lr_at(5e-4, 500, total - 1)) > 1e-12:
        raise AssertionError(f"resumed lr {lr} is off the schedule")
    if not psnrs or psnrs[-1] <= psnrs[0] + 1.0:
        raise AssertionError(f"train PSNR did not rise: {psnrs}")

    # the held-out view against an all-white frame
    args = config_parser().parse_args(base)
    ds = load_datasets(args)
    it, view, vpsnr, vssim = vals[-1]
    white = float(np.mean((1.0 - ds.images[int(view)]) ** 2))
    white_psnr = -10.0 * math.log10(white)
    log(f"held-out view {view} at step {it}: PSNR {float(vpsnr):.2f} dB, SSIM {vssim}; "
        f"all-white frame {white_psnr:.2f} dB")
    if not float(vpsnr) >= white_psnr + 2.0:
        raise AssertionError("held-out PSNR is not 2 dB above the all-white frame")

    # both checkpoint formats carry Adam state
    expdir = os.path.join(logs, "lego_smoke")
    tar = torch.load(os.path.join(expdir, f"{total:06d}.tar"), map_location="cpu",
                     weights_only=True)
    st = tar["optimizer_state_dict"]["state"]
    with np.load(os.path.join(expdir, f"{total:06d}.ckpt.npz")) as z:
        npz_count = int(z["opt/count"])
        npz_mu = float(np.abs(z["opt/mu/fine/pts_linears/0/w"]).max())
    if not (len(st) == len(state2.parameters()) and int(st[0]["step"]) == total
            and npz_count == total
            and float(st[0]["exp_avg"].abs().max()) > 0 and npz_mu > 0):
        raise AssertionError("checkpoints lack Adam state")
    pngs = sorted(f for f in os.listdir(os.path.join(
        expdir, f"renderonly_test_{total:06d}")) if f.endswith(".png"))
    per_view = 2 * len(ds.i_test) * math.ceil(400 * 400 / args.chunk)
    if len(pngs) != len(ds.i_test) or render_launches != {"fused_mlp": per_view,
                                                          "composite": per_view}:
        raise AssertionError(f"render_only: {len(pngs)} PNGs, launches {render_launches}")
    ms_step = 1e3 * args.N_rand / statistics.median(rps[1:])
    log(f"trained {steps} + {more} steps in {wall:.1f} s ({first_wall:.1f} s for the first "
        f"{steps}, hooks and start-up included); median {statistics.median(rps[1:]):,.0f} "
        f"rays/s = {ms_step:.1f} ms per step; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} "
        f"dB; launches {launches}; render_only {len(pngs)} views, launches "
        f"{render_launches}")
    return {"launches": launches, "ms_per_step": ms_step,
            "rays_per_s": statistics.median(rps[1:]), "train_psnr": psnrs,
            "val": [(int(a), int(b), float(c), float(d)) for a, b, c, d in vals],
            "white_psnr": white_psnr, "render_launches": render_launches,
            "base_argv": base, "fine_ckpt": os.path.join(expdir, f"{total:06d}.tar")}


def profile_train_step(device, steps=5, recipe="lego"):
    """``steps`` consecutive kernel training steps of ``recipe``
    (train_step_setup) under torch.profiler (after one warm-up step):
    device busy share of their wall time and the top kernels. Several
    steps, so the host's run-ahead between steps is part of the window, as
    it is in training."""
    import torch

    state, step, images, poses, ov, _ = train_step_setup(device, True, recipe)
    step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
    torch.cuda.synchronize()

    def run():
        for i in range(steps):
            step(state, images, poses, torch.Generator().manual_seed(i), overrides=ov)

    _profile(f"{steps} {recipe} training steps", run)


def profile_proposal_step(device, steps=5):
    """``steps`` consecutive steps of phase 12's recipe (proposal_step_setup:
    the proposal, loss sampling, EMA, distortion; the pixels and the tail
    drawn unpinned) through the kernels, then through the plain path, each
    under torch.profiler after one warm-up step."""
    import torch

    for fused in (True, False):
        state, step, images, poses, ov, _ = proposal_step_setup(device, fused)
        step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
        torch.cuda.synchronize()

        def run():
            for i in range(steps):
                step(state, images, poses, torch.Generator().manual_seed(i), overrides=ov)

        _profile(f"{steps} proposal training steps ({'kernels' if fused else 'plain'})",
                 run, top_n=14)


def profile_occ_step(device, trained, steps=50):
    """One dispatch window of the occupancy-gated trainer under
    torch.profiler: ``steps`` occ steps through B1 + B2 (draws unpinned)
    from phase 6's weights on a grid refreshed once, then the refresh that
    ends the window, after one warm-up step."""
    import torch

    from nerf_shared_tpu_torch.train.occ_train import (
        binarize_density_grid,
        init_density_grid,
        make_occ_train_step,
        update_density_grid,
    )

    setup = occ_setup(device, trained)
    a = setup["args"]
    state = occ_state(setup, device)
    rc = occ_rcfg(setup, True, 0.0)
    dg = update_density_grid(init_density_grid(*setup["aabb"], a.train_occ_res, device),
                             state.fine.params(), setup["cfg"], rc)
    occ = binarize_density_grid(dg, setup["alpha"])
    step = make_occ_train_step(rc, setup["cfg"], setup["spec"],
                               n_candidates=a.train_occ_candidates,
                               n_keep=a.train_occ_keep, explore=a.train_occ_explore)
    step(state, occ, setup["images"], setup["poses"], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()

    def run():
        for i in range(steps):
            step(state, occ, setup["images"], setup["poses"],
                 torch.Generator().manual_seed(i + 1))
        update_density_grid(dg, state.fine.params(), setup["cfg"], rc,
                            decay=a.train_occ_decay)

    _profile(f"{steps} occ steps and one refresh", run, top_n=12)


def profile_grid_step(device, steps=5, vertex=False):
    """``steps`` consecutive hashgrid training steps (the phase-9 split
    recipe, or with ``vertex`` the family's defaults: vertex L16/F2/T2^19;
    on train_step_setup's two seeded 400x400 images and pinned draws) under
    torch.profiler, after one warm-up step."""
    import torch

    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    _, _, images, poses, ov, _ = train_step_setup(device, False)
    box = dict(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)
    cfg = (HashGridConfig(**box) if vertex else
           HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split", **box))
    state = create_train_state(cfg, cfg, device, seed=3, lrate=5e-4, lrate_decay=500)
    H = 400
    focal = 0.5 * H / math.tan(0.5 * 0.6911112)
    spec = PixelSamplerSpec.from_K(H, H, [[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]],
                                   1024, single_image=True, precrop_iters=500,
                                   precrop_frac=0.5)
    rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64, use_viewdirs=True,
                        white_bkgd=True, near=2.0, far=6.0)
    step = make_train_step(rcfg, cfg, cfg, spec)
    step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
    torch.cuda.synchronize()

    def run():
        for i in range(steps):
            step(state, images, poses, torch.Generator().manual_seed(i), overrides=ov)

    _profile(f"{steps} hashgrid training steps ({cfg.layout} L{cfg.L}/F{cfg.F}/"
             f"T2^{cfg.log2_T})", run)


def write_scene(root, size=800, n_train=2, n_val=1, n_test=2):
    """A blender-format scene: an RGBA blob seen from the lego orbit."""
    import numpy as np

    from nerf_shared_tpu_torch.data.images import imwrite_u8
    from nerf_shared_tpu_torch.data.poses import pose_spherical

    yy, xx = np.mgrid[:size, :size]
    blob = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0], img[..., 1], img[..., 3] = blob * 200, blob * 80, blob * 255
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            rel = f"{split}/r_{i}"
            imwrite_u8(os.path.join(root, rel + ".png"), img)
            pose = pose_spherical(360.0 * i / n, -30.0, 4.0)
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112, "frames": frames}, f)


def http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


class Served:
    """The port's HTTP service on port 0, as apps/serve.main builds it (on
    ``ds`` when given, so several services share one loaded dataset)."""

    def __init__(self, argv, ds=None):
        from nerf_shared_tpu_torch.apps.serve import RenderService, make_server, serve_parser
        from nerf_shared_tpu_torch.apps.train import build_eval_engine

        self.args = serve_parser().parse_args(argv)
        self.service = RenderService(self.args, build_eval_engine(self.args, ds=ds))
        self.server = make_server(self.service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def frame_mask(engine, c2w):
    """Pixels whose final fine sample has |sigma| >= 1e-2 (clear of the 1e10
    sentinel), from a B3 render of the frame with raw outputs."""
    import torch

    with torch.no_grad():
        _, _, _, extras = engine.renderer.render(
            engine.H, engine.W, engine.K, engine.coarse, engine.fine,
            chunk=engine.args.chunk, c2w=c2w, retraw=True)
    return (extras["raw"][..., -1, 3].abs() >= 1e-2).cpu().numpy()


def phase_serving(device, size=800):
    import dataclasses

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.data.images import png_decode
    from nerf_shared_tpu_torch.data.poses import pose_spherical
    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp, fused_render
    from nerf_shared_tpu_torch.render.renderer import Renderer
    from nerf_shared_tpu_torch.utils.checkpoints import save_tar
    from nerf_shared_tpu_torch.utils.metrics import to8b

    scene, logs = os.path.join(WORK, "scene"), os.path.join(WORK, "logs")
    t0 = time.perf_counter()
    write_scene(scene, size)
    g = torch.Generator().manual_seed(1)
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4, output_ch=5)
    coarse, fine = NeRF(cfg, generator=g), NeRF(cfg, generator=g)
    save_tar(os.path.join(logs, "smoke", "000000.tar"), coarse.state_dict(),
             fine.state_dict(), 0)
    argv = ["--config", os.path.join(REPO, "configs", "lego.txt"),
            "--datadir", scene, "--basedir", logs, "--expname", "smoke",
            "--port", "0", "--device", device]
    served = Served(argv)
    eng = served.service.engine
    log(f"scene + checkpoint + engine in {time.perf_counter() - t0:.1f} s: "
        f"{eng.W}x{eng.H} frames, chunk {eng.args.chunk}, engine {eng.engine_name}")
    H = size // 2  # lego.txt: half_res
    if (eng.H, eng.W) != (H, H):
        raise AssertionError(f"expected {H}x{H} frames, got {eng.W}x{eng.H}")
    per_frame = 2 * math.ceil(eng.H * eng.W / eng.args.chunk)

    pose_a = pose_spherical(30.0, -30.0, 4.0)
    try:
        zero_counts()
        t0 = time.perf_counter()
        replies = [
            http(served.base + "/render?theta=30&phi=-30&radius=4"),
            http(served.base + "/render", {"c2w": pose_a.tolist(), "fmt": "npy"}),
            http(served.base + "/render?theta=120&phi=-20&radius=4.5"),
        ]
        wall = time.perf_counter() - t0
        launches = {"fused_mlp": fused_mlp.LAUNCHES,
                    "fused_render": fused_render.LAUNCHES,
                    "composite": composite.LAUNCHES}
        code, ctype, metrics = http(served.base + "/metrics")
        health = json.loads(http(served.base + "/health")[2])
        info = json.loads(http(served.base + "/info")[2])
    finally:
        served.close()
    lat = served.service._latencies
    log(f"served 3 frames in {wall:.2f} s: {', '.join(f'{x * 1e3:.0f}' for x in lat)} "
        f"ms per frame (server side); launches {launches}; info {info}")
    if code != 200 or "nerf_render_frames_total 3" not in metrics.decode():
        raise AssertionError(f"/metrics: {code} {metrics[:200]!r}")
    if health != {"status": "ok", "step": 0} or info["device"] != device:
        raise AssertionError(f"/health {health} /info {info}")
    for status, ct, _ in replies:
        if status != 200:
            raise AssertionError(f"render request failed: {status} {ct}")
    png_a, png_b = png_decode(replies[0][2]), png_decode(replies[2][2])
    frame = np.load(io.BytesIO(replies[1][2]))
    for name, img in (("GET png", png_a), ("GET png", png_b)):
        if img.shape != (H, H, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{name}: {img.shape} {img.dtype}")
    if frame.shape != (H, H, 3) or not np.isfinite(frame).all():
        raise AssertionError(f"POST npy frame is not a finite {H}x{H}x3 image")
    if not np.array_equal(to8b(frame), png_a):
        raise AssertionError("PNG and npy renders of one pose differ")
    if launches != {"fused_mlp": 3 * per_frame, "fused_render": 0,
                    "composite": 3 * per_frame}:
        raise AssertionError(f"expected {3 * per_frame} B3 and B5 launches, got {launches}")

    # the frame against the plain renderer on a band of 4000 rays
    plain = Renderer(**{**dataclasses.asdict(eng.renderer.cfg), "perturb": 0.0,
                        "use_pallas": False, "fused_composite": False})
    c2w = torch.as_tensor(pose_a[:3, :4], device=device)
    rays, _ = plain._pack_rays(eng.H, eng.W, eng.K, None, c2w, device)
    band = slice((H // 2 - 5) * H, (H // 2 + 5) * H)
    with torch.no_grad():
        ref = plain.render_flat_rays(rays[band], eng.coarse, eng.fine,
                                     chunk=eng.args.chunk, retraw=True)
    keep = (ref["raw"][:, -1, 3].abs() >= 1e-2).cpu().numpy()
    err = float(np.abs(frame.reshape(-1, 3)[band][keep]
                       - ref["rgb_map"].cpu().numpy()[keep]).max())
    log(f"served frame vs plain renderer on {int(keep.sum())}/{10 * H} band rays: "
        f"max err {err:.2e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("served frame disagrees with the plain renderer")
    mask = frame_mask(eng, c2w)

    # phase 4: the same request through an engine with --fused_composite
    served = Served(argv + ["--fused_composite", "True"])
    try:
        zero_counts()
        status, _, body = http(served.base + "/render",
                               {"c2w": pose_a.tolist(), "fmt": "npy"})
        fused_launches = {"fused_mlp": fused_mlp.LAUNCHES,
                          "fused_render": fused_render.LAUNCHES,
                          "composite": composite.LAUNCHES}
    finally:
        served.close()
    fused_frame = np.load(io.BytesIO(body))
    ferr = float(np.abs(fused_frame - frame)[mask].max())
    log(f"fused-composite frame: {served.service._latencies[0] * 1e3:.0f} ms, "
        f"launches {fused_launches}, max err vs phase 3 {ferr:.2e} over "
        f"{int(mask.sum())}/{mask.size} masked pixels (tol 1e-3)")
    if status != 200 or not np.isfinite(fused_frame).all():
        raise AssertionError("fused-composite request failed")
    if fused_launches != {"fused_mlp": per_frame // 2, "fused_render": per_frame // 2,
                          "composite": per_frame // 2}:
        raise AssertionError(f"fused-composite launches: {fused_launches}")
    if not ferr <= 1e-3:
        raise AssertionError("fused-composite frame disagrees with phase 3")
    return {"launches": {"dense": launches, "fused_composite": fused_launches},
            "frame_ms": {"dense": [x * 1e3 for x in lat],
                         "fused_composite": [x * 1e3 for x in
                                             served.service._latencies]},
            "engine": eng, "pose": pose_a}


FAST_ENGINES = (
    ("guided", ["--render_guided", "48"], "dense"),
    ("gated", ["--render_gate", "1e-3"], "gated"),
    ("occ_froxel", ["--occ_grid", "128", "--occ_keep", "32", "--occ_fine", "16"],
     "occ-froxel"),
    ("occ_grid", ["--occ_grid", "128", "--occ_keep", "32", "--occ_fine", "16",
                  "--occ_mode", "grid"], "occ-grid"),
)


def launch_counts():
    from nerf_shared_tpu_torch.ops.cuda import (
        composite, fused_mlp, fused_mlp_bwd, fused_render, gather)

    return {"fused_mlp_points": fused_mlp.POINT_LAUNCHES, "fused_mlp": fused_mlp.LAUNCHES,
            "fused_render": fused_render.LAUNCHES, "fused_mlp_bwd": fused_mlp_bwd.LAUNCHES,
            "composite": composite.LAUNCHES, "gather": gather.LAUNCHES["gather"],
            "scatter_add": gather.LAUNCHES["scatter_add"],
            "fused_mlp_points_bf16": fused_mlp.POINT_LAUNCHES_BF16,
            "fused_mlp_bf16": fused_mlp.LAUNCHES_BF16,
            "fused_render_bf16": fused_render.LAUNCHES_BF16,
            "fused_mlp_bwd_bf16": fused_mlp_bwd.LAUNCHES_BF16,
            "fused_mlp_points_ipe": fused_mlp.POINT_LAUNCHES_IPE,
            "fused_mlp_bwd_ipe": fused_mlp_bwd.LAUNCHES_IPE}


def zero_counts():
    from nerf_shared_tpu_torch.ops.cuda import (
        composite, fused_mlp, fused_mlp_bwd, fused_render, gather)

    fused_mlp.POINT_LAUNCHES = fused_mlp.LAUNCHES = fused_render.LAUNCHES = 0
    fused_mlp_bwd.LAUNCHES = composite.LAUNCHES = 0
    fused_mlp.POINT_LAUNCHES_BF16 = fused_mlp.LAUNCHES_BF16 = 0
    fused_render.LAUNCHES_BF16 = fused_mlp_bwd.LAUNCHES_BF16 = 0
    fused_mlp.POINT_LAUNCHES_IPE = fused_mlp.IPE_POINTS = fused_mlp_bwd.LAUNCHES_IPE = 0
    fused_mlp.SAVED_H_POINTS = 0
    gather.LAUNCHES.update(gather=0, scatter_add=0)


def engine_maps(eng, kernels, c2w, guided=None, occ_fine=None):
    """(rgb [H,W,3], acc [H,W], z, live, active) of one pose through
    ``eng``'s path, as render_from_batch_poses dispatches it, with the
    kernels or through the plain versions (``kernels`` False); ``guided``
    and ``occ_fine`` override the config's. z is the fine pass's sample
    depths [H,W,S] on the dense (guided) path and the occupancy engines'
    --occ_fine pass, else None; live [H,W] marks the rays that keep an
    occupied sample (occupancy), else None; active is the share of rays
    that reach the fine pass (gated) or keep an occupied sample
    (occupancy), else None."""
    import dataclasses

    import torch

    from nerf_shared_tpu_torch.apps.train import _occ_render_args
    from nerf_shared_tpu_torch.render.renderer import Renderer

    a = eng.args
    cfg = dataclasses.asdict(eng.renderer.cfg)
    cfg.update(perturb=0.0, raw_noise_std=0.0,
               use_pallas=kernels and cfg["use_pallas"],
               fused_composite=kernels and cfg["fused_composite"])
    if guided is not None:
        cfg["guided"] = guided
    r = Renderer(**cfg)
    with torch.no_grad():
        if eng.occ_grid is not None:
            o = _occ_render_args(a)
            _, out = r.render_image_occ(
                eng.H, eng.W, eng.K, c2w, eng.fine, eng.occ_grid, chunk=a.chunk,
                n_candidates=o["occ_candidates"], n_keep=o["occ_keep"],
                mode=o["occ_mode"], tile=o["occ_tile"], select=o["occ_select"],
                n_fine=o["occ_fine"] if occ_fine is None else occ_fine)
            rgb, acc, live = out["rgb_map"], out["acc_map"], out["n_active"] > 0
            z = out["z_vals"].cpu().numpy() if "z_vals" in out else None
            active = float(live.float().mean())
            live = live.cpu().numpy()
        elif a.render_gate > 0.0:
            _, out = r.render_image_gated(eng.H, eng.W, eng.K, c2w, eng.coarse,
                                          eng.fine, chunk=a.chunk,
                                          threshold=a.render_gate)
            rgb, acc, z, live = out["rgb_map"], out["acc_map"], None, None
            active = out["active_fraction"]
        else:
            rgb, _, acc, extras = r.render(eng.H, eng.W, eng.K, eng.coarse, eng.fine,
                                           chunk=a.chunk, c2w=c2w, retraw=False,
                                           retweights=True)
            z, live, active = extras["z_vals"].cpu().numpy(), None, None
    return rgb.float().cpu().numpy(), acc.float().cpu().numpy(), z, live, active


@contextlib.contextmanager
def plain_gathers():
    """The grid families' table reads through plain indexing instead of P1
    (for holding a grid frame against its plain version; forward only)."""
    from nerf_shared_tpu_torch.models import hashgrid, triplane

    def plain(table, idx):
        return table[idx.reshape(-1).long()].reshape(*idx.shape, table.shape[1])

    saved = hashgrid.table_gather, triplane.table_gather
    hashgrid.table_gather = triplane.table_gather = plain
    try:
        yield
    finally:
        hashgrid.table_gather, triplane.table_gather = saved


def plain_fine_pass(eng, c2w, z, live=None, forward=None):
    """(rgb [H,W,3], acc [H,W]) of ``eng``'s fine network at the depths z
    [H,W,S] through the plain versions (network and raw2outputs); with
    ``live`` [H,W], the other rays' densities masked as the occupancy
    engines mask rays that keep no occupied sample; ``forward(params,
    cfg, rays_o, rays_d, z, viewdirs)`` replaces the plain network."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.ops.compositing import raw2outputs
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import plain_nerf_forward_rays
    from nerf_shared_tpu_torch.render.occupancy import _masked_sigma
    from nerf_shared_tpu_torch.render.renderer import _apply_model

    def grid_forward(params, cfg, ro, rd, zz, vd):
        pts = ro[:, None, :] + rd[:, None, :] * zz[..., None]
        with plain_gathers():
            return _apply_model(params, cfg, pts, vd, eng.renderer.cfg)

    if forward is None:
        forward = (plain_nerf_forward_rays if isinstance(eng.fine.cfg, NeRFConfig)
                   else grid_forward)

    dev = eng.device
    rays, _ = eng.renderer._pack_rays(eng.H, eng.W, eng.K, None,
                                      torch.as_tensor(c2w, device=dev), dev)
    z = torch.as_tensor(z, device=dev).reshape(rays.shape[0], -1)
    if live is not None:
        live = torch.as_tensor(live, device=dev).reshape(-1, 1)
    params, cfg = eng.fine.params(), eng.fine.cfg
    rgb, acc = [], []
    with torch.no_grad():
        for i in range(0, rays.shape[0], eng.args.chunk):
            rb, zz = rays[i:i + eng.args.chunk], z[i:i + eng.args.chunk].contiguous()
            ro, rd, vd = (rb[:, 0:3].contiguous(), rb[:, 3:6].contiguous(),
                          rb[:, -3:].contiguous())
            raw = forward(params, cfg, ro, rd, zz, vd)
            if live is not None:
                raw = _masked_sigma(raw, live[i:i + eng.args.chunk].expand_as(zz))
            out = raw2outputs(raw, zz, rd, white_bkgd=eng.renderer.cfg.white_bkgd)
            rgb.append(out[0])
            acc.append(out[2])
    return (torch.cat(rgb).reshape(eng.H, eng.W, 3).cpu().numpy(),
            torch.cat(acc).reshape(eng.H, eng.W).cpu().numpy())


def psnr(a, b):
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return -10.0 * math.log10(mse) if mse > 0 else float("inf")


def held(rgb_a, acc_a, rgb_b, acc_b, rays=None):
    """(max rgb error, rays held, sentinel flips) of frame a against frame b
    over the rays ``rays`` marks ([H,W]; all when None). Rays whose acc
    moved as a flip of the last sample's 1e10 interval moves it
    (|d rgb| <= |d acc|, |d acc| > 1e-3) are set apart and counted."""
    import numpy as np

    d_rgb, d_acc = np.abs(rgb_a - rgb_b).max(-1), np.abs(acc_a - acc_b)
    rays = np.ones(d_rgb.shape, bool) if rays is None else rays
    flip = rays & (d_acc > 1e-3) & (d_rgb <= d_acc + 1e-5)
    keep = rays & ~flip
    return float(d_rgb[keep].max(initial=0.0)), int(keep.sum()), int(flip.sum())


def frame_checks(eng, c2w, kern):
    """The checks of one phase 7 frame: ``kern`` is engine_maps' tuple
    with the kernels. Returns ({label: held(...)}, moved, live, note); the
    first check is the frame's main one.

    The gated engine places no sample from the network's output: its frame
    is held against the plain versions' as it is. The guided path and the
    occupancy engines' --occ_fine pass place fine samples by inverse CDF,
    whose 1e-5 floor on a CDF step is a discontinuity (1e-7 differences of
    the coarse weights move samples by up to ~6e-2 on a 400x400 lego
    frame). Their frame is held through the plain versions at the kernel
    run's own depths (every ray). The occupancy engines' frame is also held
    against the plain run as it is over the rays whose samples did not move
    by more than 1e-5, with the rays that moved at most three quarters of
    the live rays, and their coarse pass alone (--occ_fine 0), whose
    samples come from the grid and never move, as it is. (Guided's 48 fine
    samples crowd where the coarse weights peak, so there a 1e-5 shift can
    be a large share of a sample interval: the unmoved rays read 1.01e-3 on
    an H100; only the moved share is printed.)"""
    import numpy as np

    rgb_k, acc_k, z_k, live_k, _ = kern
    rgb_p, acc_p, z_p, _, _ = engine_maps(eng, False, c2w)
    if z_k is None:
        return {"frame": held(rgb_k, acc_k, rgb_p, acc_p)}, None, None, ""
    checks = {"at the kernel run's depths": held(
        rgb_k, acc_k, *plain_fine_pass(eng, c2w, z_k, live_k))}
    shift = np.abs(z_k - z_p).max(-1)
    still = shift <= 1e-5
    n_moved = int((~still).sum())
    live = still.size if live_k is None else int(live_k.sum())
    moved = None
    if eng.occ_grid is not None:
        moved = n_moved
        checks["as it is, unmoved rays"] = held(rgb_k, acc_k, rgb_p, acc_p, still)
        coarse = [engine_maps(eng, k, c2w, occ_fine=0) for k in (True, False)]
        checks["coarse pass alone"] = held(coarse[0][0], coarse[0][1],
                                           coarse[1][0], coarse[1][1])
    note = (f" ({n_moved} of {live} live rays with samples moved > 1e-5, by up to "
            f"{shift.max():.1e}{'; at most 3/4 allowed' if moved is not None else ''}; "
            f"over all rays as it is {float(np.abs(rgb_k - rgb_p).max()):.2e})")
    return checks, moved, live, note


def time_grid_build(eng):
    """ms of the occupancy engines' 128^3 grid build (probes through B1 and
    through the plain apply_nerf), in turns kernel, plain, plain, kernel,
    host clock to a synchronize: ((median, min, max) kernels, the same
    plain, B1 launches a kernel build, share of cells the two builds
    mark differently)."""
    import dataclasses

    import torch

    from nerf_shared_tpu_torch.apps.train import resolved_occ_alpha_thresh
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp
    from nerf_shared_tpu_torch.render.occupancy import build_occupancy_grid

    grid0 = eng.occ_grid
    params = eng.fine.params()

    def build(kernels):
        rcfg = dataclasses.replace(eng.renderer.cfg, use_pallas=kernels)
        gen = torch.Generator(device=grid0.grid.device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            grid = build_occupancy_grid(
                params, eng.fine.cfg, rcfg, grid0.aabb_min.cpu().numpy(),
                grid0.aabb_max.cpu().numpy(), resolution=grid0.resolution,
                alpha_threshold=resolved_occ_alpha_thresh(eng.args), generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, grid.grid

    times = {True: [], False: []}
    before = fused_mlp.POINT_LAUNCHES
    grids = {}
    for kernels in (True, False, False, True):
        ms, grids[kernels] = build(kernels)
        times[kernels].append(ms)
    launches = (fused_mlp.POINT_LAUNCHES - before) // 2
    differ = float((grids[True] != grids[False]).float().mean())
    return (tuple((statistics.median(t), min(t), max(t)) for t in (times[True], times[False]))
            + (launches, differ))


def phase_fast_serving(device, base_argv, profile=False):
    """Phase 7: the fast engines over HTTP on phase 6's checkpoint (with
    ``profile``, one more frame of each engine under torch.profiler)."""
    import numpy as np

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets

    argv = base_argv + ["--port", "0"]
    ds = load_datasets(serve_parser().parse_args(argv))
    view = int(ds.i_test[0])
    pose, gt = ds.poses[view][:3, :4], ds.images[view]
    per_frame = None
    results, dense, bad = {}, None, []
    for name, flags, engine in FAST_ENGINES:
        zero_counts()
        t0 = time.perf_counter()
        served = Served(argv + flags, ds=ds)
        build_s = time.perf_counter() - t0
        build = launch_counts()
        eng = served.service.engine
        try:
            zero_counts()
            status, _, body = http(served.base + "/render",
                                   {"c2w": pose.tolist(), "fmt": "npy"})
            launches = launch_counts()
            status2, _, body2 = http(served.base + "/render",
                                     {"c2w": pose.tolist(), "fmt": "npy"})
            info = json.loads(http(served.base + "/info")[2])
        finally:
            served.close()
        frame = np.load(io.BytesIO(body))
        # the first request of an engine meets its shapes for the first time
        first_ms, ms = (t * 1e3 for t in served.service._latencies[:2])
        again = float(np.abs(np.load(io.BytesIO(body2)) - frame).max()) if status2 == 200 else None
        if again is None or not again <= 1e-6:
            raise AssertionError(f"{name}: a second request of the pose gave {status2}, "
                                 f"max difference {again}")
        if per_frame is None:
            per_frame = math.ceil(eng.H * eng.W / eng.args.chunk)
        if status != 200 or frame.shape != (eng.H, eng.W, 3) or not np.isfinite(frame).all():
            raise AssertionError(f"{name}: no finite {eng.H}x{eng.W} frame ({status})")
        if info["engine"] != engine or info["occ_fine"] != eng.args.occ_fine:
            raise AssertionError(f"{name}: /info {info}")
        if launches["fused_render"] or launches["fused_mlp_bwd"]:
            raise AssertionError(f"{name}: B2 or B4 launched: {launches}")
        b1, b3, b5 = (launches[k] for k in ("fused_mlp_points", "fused_mlp", "composite"))
        if name == "guided" and (b1, b3, b5) != (0, 2 * per_frame, 2 * per_frame):
            raise AssertionError(f"guided: expected {2 * per_frame} B3 and B5: {launches}")
        if name == "gated" and not (b3 == 0 and b1 >= per_frame and b5 == b1):
            raise AssertionError(f"gated: expected B1 and B5 once per stage block: {launches}")
        if name.startswith("occ"):
            if build["fused_mlp_points"] != 128 or sum(build.values()) != 128:
                raise AssertionError(f"{name}: the 128^3 grid build launched {build}")
            if not (b1 == 0 and b3 > 0 and b5 == b3):
                raise AssertionError(f"{name}: expected B3 + B5 pairs: {launches}")

        # the same engine through the plain versions on the same grid (see
        # frame_checks)
        c2w = np.asarray(pose, np.float32)
        kern = engine_maps(eng, True, c2w)
        rgb_k, active = kern[0], kern[4]
        checks, moved, n_live, depth_note = frame_checks(eng, c2w, kern)
        same = float(np.abs(rgb_k - frame).max())
        err, _, flips = next(iter(checks.values()))
        if dense is None:
            dense = engine_maps(eng, True, c2w, guided=0)[0]
        occ = eng.occ_grid.occupied_fraction() if eng.occ_grid is not None else None
        size = rgb_k.shape[0] * rgb_k.shape[1]
        log(f"{name}: engine {info['engine']}, {ms:.1f} ms per frame ({first_ms:.1f} ms the "
            f"first, second request's frame {again:.1e} from the first; engine build "
            f"{build_s:.1f} s, launches {build}); request launches B1 {b1}, B3 {b3}, "
            f"B5 {b5}; vs plain versions (tol 1e-3, sentinel flips set apart): "
            + "; ".join(f"{label} max err {e:.2e} over {n}/{size} rays ({f} flips)"
                        for label, (e, n, f) in checks.items())
            + f"{depth_note}; HTTP frame vs direct render {same:.1e}; "
            f"occupied {occ}; active rays {active}; PSNR vs dense {psnr(frame, dense):.2f} dB, "
            f"vs held-out view {view} {psnr(frame, gt):.2f} dB")
        if not (all(e <= 1e-3 and f <= size // 1000 for e, _, f in checks.values())
                and same <= 1e-6 and (moved is None or 4 * moved <= 3 * n_live)):
            bad.append(name)
        if profile:
            _profile(f"{name} frame", lambda: eng.render_poses(pose[None]))
        if name == "occ_froxel":
            tk, tp, n_b1, differ = time_grid_build(eng)
            log(f"grid build {eng.occ_grid.resolution}^3: {spread(tk)} ms through B1 "
                f"({n_b1} launches) vs {spread(tp)} ms through the plain version "
                f"(median [min-max] of 2 builds in turns); {differ:.2e} of the cells "
                "marked differently by the two builds")
            results["grid_build"] = {"ms": tk[0], "ms_min": tk[1], "ms_max": tk[2],
                                     "plain_ms": tp[0], "plain_min": tp[1],
                                     "plain_max": tp[2], "launches": n_b1,
                                     "cells_differ": differ}
        results[name] = {
            "engine": info["engine"], "frame_ms": ms, "first_frame_ms": first_ms,
            "build_s": build_s,
            "build_launches": build, "launches": launches, "max_err": err,
            "sentinel_flips": flips, "checks": {k: v[0] for k, v in checks.items()},
            "moved_rays": moved, "live_rays": n_live, "occupied_fraction": occ,
            "active_fraction": active,
            "psnr_vs_dense": psnr(frame, dense), "psnr_vs_gt": psnr(frame, gt)}
    results["dense_psnr_vs_gt"] = psnr(dense, gt)
    log(f"dense frame of the same checkpoint vs held-out view {view}: "
        f"{results['dense_psnr_vs_gt']:.2f} dB")
    log("phase 7 times: " + ", ".join(f"{name} frame {results[name]['frame_ms']:.1f} ms"
                                      for name, *_ in FAST_ENGINES)
        + f"; 128^3 grid build {results['grid_build']['ms']:.1f} ms")
    if bad:
        raise AssertionError(f"the kernels' frame disagrees with the plain versions: {bad}")
    return results


def gather_inputs(R, T, w, seed, device, same=False, idx=None, offset=0):
    """Seeded table [T, w], int32 indices [R] and updates [R, w] on the
    card. ``same``: every index T // 2 and integer updates in [-8, 8], whose
    fp32 sums (|sum| <= 8 R < 2^24) are exact in any order. ``idx``: these
    indices (int32 on the card) in place of uniform draws, with the table
    and updates drawn on the card. ``offset``: table and updates start
    ``offset`` floats into their buffers (unaligned for the vector paths)."""
    import torch

    if idx is not None:
        gd = torch.Generator(device=device).manual_seed(seed)
        return (torch.randn(T, w, generator=gd, device=device), idx,
                torch.randn(R, w, generator=gd, device=device))
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(T, w, generator=g)
    if same:
        idx = torch.full((R,), T // 2, dtype=torch.int32)
        upd = torch.randint(-8, 9, (R, w), generator=g).float()
    else:
        idx = torch.randint(0, T, (R,), generator=g, dtype=torch.int32)
        upd = torch.randn(R, w, generator=g)

    def place(t):
        buf = torch.zeros(t.numel() + offset, device=device)
        buf[offset:] = t.reshape(-1).to(device)
        return buf[offset:].view(t.shape)

    return place(table), idx.to(device), place(upd)


def check_gather(label, R, T, w, seed, device, same=False, idx=None, offset=0):
    """P1 and P2 against their plain versions on one input: P1 exactly, P2
    within 1e-5 of the largest |entry| (fp32 atomics add in another order),
    exactly with ``same`` (integer updates). Returns (inputs, P1 max err,
    P2 max err over the largest |entry|)."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import gather

    table, idx, upd = gather_inputs(R, T, w, seed, device, same, idx, offset)
    with torch.no_grad():
        got, want = gather.gather_rows(table, idx), gather.plain_gather_rows(table, idx)
        s_got = gather.scatter_add_rows(idx, upd, T)
        s_want = gather.plain_scatter_add_rows(idx, upd, T)
    torch.cuda.synchronize()
    e1 = float((got - want).abs().max()) if R else 0.0
    scale = max(1.0, float(s_want.abs().max()))
    e2 = float((s_got - s_want).abs().max()) / scale
    tol = 0.0 if same else 1e-5
    log(f"  {label} R={R} T={T} w={w}{f' offset {offset}' if offset else ''}: P1 max err "
        f"{e1:.1e} (exact), P2 max err {e2:.1e} of max|out| {scale:.3g} (tol {tol:g})")
    if got.shape != (R, w) or s_got.shape != (T, w) or e1 != 0.0 or not e2 <= tol:
        raise AssertionError(f"P1 / P2 disagree with their plain versions at {label}")
    return (table, idx, upd), e1, e2


def in_turns(a, b, rounds=5, reps=20):
    """Device ms per call of ``a`` and ``b`` (queued_ms, ``reps`` calls a
    sample) timed in turns a, b, b, a over ``rounds`` rounds: (median, min,
    max) of each one's 2 x rounds samples."""
    sa, sb = [], []
    for _ in range(rounds):
        for fn, out in ((a, sa), (b, sb), (b, sb), (a, sa)):
            out.append(queued_ms(fn, reps=reps, rounds=1))
    return tuple((statistics.median(s), min(s), max(s)) for s in (sa, sb))


def main_path_indices(device):
    """The indices the grid families' encode builds for one training step
    of seeded lego rays (1024 rays), through the port's own index math:
    [(label, idx int32 [R] on the card, T, w)]. Split L8/F8/T2^14 levels 0,
    3, 7 and the vertex L16/F2/T2^19 fused gather on the fine pass (64 +
    128 samples a ray); one triplane G256/C16 plane gather (plane xy,
    corner 00) on 64 + 192 samples a ray."""
    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig, hashgrid_indices
    from nerf_shared_tpu_torch.models.triplane import TriplaneConfig, triplane_indices

    box = dict(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)

    def points(S, seed):
        o, d, z, _ = lego_rays(1024, S, seed, device)
        return o[:, None, :] + d[:, None, :] * z[..., None]

    fine = points(192, 20)
    split = HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split", **box)
    levels = hashgrid_indices(split, fine)
    cases = [(f"split L8/F8 level {lv}, fine pass, main-path indices", levels[lv],
              split.level_table_rows[lv], split.row_width) for lv in (0, 3, 7)]
    vertex = HashGridConfig(**box)
    cases.append(("vertex L16/F2/T2^19, fine pass, main-path indices",
                  hashgrid_indices(vertex, fine).reshape(-1), vertex.L * vertex.T, vertex.F))
    tri = TriplaneConfig(**box)
    cases.append(("triplane G256/C16, plane xy corner 00, main-path indices",
                  triplane_indices(tri, points(256, 21))[0, 0].reshape(-1).contiguous(),
                  3 * tri.G * tri.G, tri.C))
    return cases


def time_gather(label, inputs, T, w, errs, main=False):
    """P1 and P2 on one input, each in turns with its library call
    (index_select; zeros + index_add_), plus the plain versions' time and
    the bytes bounds. Returns the two kernels' case records."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import gather

    table, idx, upd = inputs
    R, device = idx.shape[0], table.device
    with torch.no_grad():
        p1, lib1 = in_turns(lambda: gather.gather_rows(table, idx),
                            lambda: torch.index_select(table, 0, idx))
        p2, lib2 = in_turns(lambda: gather.scatter_add_rows(idx, upd, T),
                            lambda: torch.zeros((T, w), device=device).index_add_(0, idx, upd))
        plain = (queued_ms(lambda: gather.plain_gather_rows(table, idx)),
                 queued_ms(lambda: gather.plain_scatter_add_rows(idx, upd, T)))
    # bytes bounds: P1 reads the distinct rows its indices name, P2 writes
    # the whole [T, w] output
    distinct = int(torch.unique(idx).numel())
    bms = {"p1": 1e3 * gather.bytes_moved(R, distinct, w) / PEAK_BYTES,
           "p2": 1e3 * gather.bytes_moved(R, T, w) / PEAK_BYTES}

    def verdict(k, lib):
        return ("beats" if k[2] < lib[1] else "loses to" if k[1] > lib[2] else "ties")

    log(f"P1 / P2 {label} (R={R} T={T} w={w}, {distinct} distinct rows): "
        f"P1 {spread(p1)} ms vs index_select {spread(lib1)} ({verdict(p1, lib1)} it), "
        f"bound {bms['p1']:.4f}, plain {plain[0]:.4f}; P2 {spread(p2)} ms vs zeros + "
        f"index_add_ {spread(lib2)} ({verdict(p2, lib2)} it), bound {bms['p2']:.4f}, "
        f"plain {plain[1]:.4f}; median [min-max] ms of 10 samples in turns")
    cases = []
    for k, t, lib, pl, e, b in (("gather", p1, lib1, plain[0], errs[0], bms["p1"]),
                                ("scatter_add", p2, lib2, plain[1], errs[1], bms["p2"])):
        cases.append(dict(
            kernel=k, shape=label, R=R, T=T, w=w, distinct_rows=distinct, main=main,
            max_abs_err=e, ms=t[0], ms_min=t[1], ms_max=t[2], plain_ms=pl,
            library_ms=lib[0], library_min=lib[1], library_max=lib[2], bound_ms=b,
            bound_by="bytes", vs_library=verdict(t, lib)))
    return cases


def phase_gather(device):
    """Phase 8: P1 and P2 at the probe's and the grid paths' shapes on
    uniform and main-path indices and at odd shapes, the autograd pair,
    times in turns with the library calls, and the ported probe."""
    import torch

    from nerf_shared_tpu_torch.benchmarks import scatter_probe
    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_shared_tpu_torch.ops.cuda import gather

    split = HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split")
    shapes = [("probe", 3_145_728, 65_536, 16)]
    for R, what in ((196_608, "fine"), (65_536, "coarse")):
        for rows in sorted(set(split.level_table_rows)):
            shapes.append((f"split L8/F8 level table ({what} pass)", R, rows,
                           split.row_width))
    shapes += [("vertex L16/F2/T2^19, one gather of a step's 262,144 points",
                262_144 * 16 * 8, 16 << 19, 2),
               ("triplane G256/C16, one of 12 gathers", 262_144, 3 * 256 * 256, 16)]
    timed = {"probe", "split L8/F8 level table (fine pass)",
             "triplane G256/C16, one of 12 gathers",
             "vertex L16/F2/T2^19, one gather of a step's 262,144 points"}
    cases = []
    for i, (label, R, T, w) in enumerate(shapes):
        inputs, e1, e2 = check_gather(label, R, T, w, 40 + i, device)
        if label in timed:
            cases += time_gather(f"{label}, uniform indices", inputs, T, w, (e1, e2))
        del inputs
    # the indices the grid families build on seeded lego rays
    for i, (label, idx, T, w) in enumerate(main_path_indices(device)):
        inputs, e1, e2 = check_gather(label, idx.shape[0], T, w, 50 + i, device, idx=idx)
        cases += time_gather(label, inputs, T, w, (e1, e2), main=label.startswith(
            "split L8/F8 level 3"))
        del inputs, idx
    # odd shapes: R prime, R = 0, T = 1, every width the kernels take, all
    # indices equal, and buffers unaligned for the vector paths
    for i, w in enumerate((1, 2, 3, 4, 8, 16, 32, 64)):
        check_gather("odd", 1237, 977, w, 60 + i, device)
    check_gather("odd", 1_000_003, 4099, 3, 70, device)
    check_gather("empty", 0, 5, 16, 71, device)
    check_gather("empty", 0, 5, 3, 72, device)
    check_gather("one row", 1000, 1, 16, 73, device)
    for i, w in enumerate((2, 4, 16, 64)):
        check_gather("unaligned", 100_003, 4099, w, 76 + i, device, offset=1)
    # every row onto one (the worst contention). Sums of n N(0, 1) rows in
    # two orders differ by ~eps sqrt(n) of the result (2.1e-5 at n =
    # 262,144 on the H100, over the 1e-5 bar), so these take integer
    # updates, whose sums are exact in any order: P2 must match exactly
    check_gather("all indices equal", 262_144, 4096, 64, 74, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 2, 75, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 16, 83, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 1, 84, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 3, 85, device, same=True)

    # the autograd pair against plain autograd
    table, idx, upd = gather_inputs(196_608, 16_384, 64, 80, device)
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    rows = gather.table_gather(t1, idx)
    (rows * upd).sum().backward()
    want = t2[idx.long()]
    (want * upd).sum().backward()
    e_rows = float((rows - want).detach().abs().max())
    e_grad = float((t1.grad - t2.grad).abs().max()) / max(1.0, float(t2.grad.abs().max()))
    log(f"TableGather: rows max err {e_rows:.1e} (exact), table gradient {e_grad:.1e} of "
        "its max (tol 1e-5)")
    if not (e_rows == 0.0 and e_grad <= 1e-5):
        raise AssertionError("TableGather disagrees with plain autograd")

    probe = scatter_probe.run(3_145_728, 65_536, 16, reps=5, device=device, out=log)
    p1, p2 = probe[6], probe[7]
    if not (p1["max_err"] == 0.0 and p2["max_err"] <= 1e-5 * max(1.0, p2["max_abs"])):
        raise AssertionError(f"the probe's kernel rows disagree: {p1} {p2}")
    return cases, probe


GRID_ARGS = ["--model_type", "hashgrid", "--hash_layout", "split", "--hash_levels", "8",
             "--hash_feat", "8", "--hash_log2_size", "14", "--hash_max_res", "512"]


def phase_grid(device, steps=400, more=200, tri_steps=100, profile=False):
    """Phase 9: the split hashgrid through train, resume, render_only and
    the HTTP service, then the triplane with one upsample milestone."""
    import re

    import numpy as np

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.train.state import lr_at

    scene, logs = os.path.join(WORK, "train_scene"), os.path.join(WORK, "grid_logs")
    if not os.path.isdir(scene):
        write_train_scene(scene)
    lego = os.path.join(REPO, "configs", "lego.txt")
    total = steps + more
    base = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "hashgrid_smoke", "--device", device, "--testskip", "1", "--i_print", "50",
            "--i_testset", "0", "--i_video", "0", "--i_img", str(total),
            "--i_weights", str(steps)] + GRID_ARGS
    ds = load_datasets(serve_parser().parse_args(base + ["--port", "0"]))
    H, W = ds.hwf[0], ds.hwf[1]
    blocks = math.ceil(H * W / 32768)
    frame = {"gather": 2 * 8 * blocks, "composite": 2 * blocks}  # per dense frame

    zero_counts()
    t0 = time.perf_counter()
    _, text = run_train_cli(base + ["--N_iters", str(steps)])
    first = launch_counts()
    state, text2 = run_train_cli(base + ["--N_iters", str(total)])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = {"gather": 16 * total + frame["gather"], "scatter_add": 16 * total,
            "composite": frame["composite"]}
    others = {k: v for k, v in launches.items() if k not in want}
    if ({k: launches[k] for k in want} != want or any(others.values())
            or first["gather"] != 16 * steps):
        raise AssertionError(f"hashgrid training launches {launches} (first run {first}), "
                             f"expected {want} and no B1-B4")
    if "Reloading from" not in text2 or state.count != total or state.step != total:
        raise AssertionError(f"hashgrid resume: count {state.count}, step {state.step}")
    lrs = {g["label"]: g["lr"] for g in state.optimizer.param_groups}
    if (abs(lrs["net"] - lr_at(5e-4, 500, total - 1)) > 1e-12
            or abs(lrs["grid"] - lr_at(2e-2, 500, total - 1)) > 1e-12):
        raise AssertionError(f"resumed lrs {lrs} are off the schedule")
    expdir = os.path.join(logs, "hashgrid_smoke")
    with np.load(os.path.join(expdir, f"{total:06d}.ckpt.npz")) as z:
        groups = (int(z["opt/n_groups"]), int(z["opt/g0/count"]), int(z["opt/g1/count"]))
        mu = float(np.abs(z["opt/g0/mu/fine/tables/0"]).max())
    if groups != (2, total, total) or not mu > 0 or any(
            f.endswith(".tar") for f in os.listdir(expdir)):
        raise AssertionError(f"hashgrid checkpoint: groups {groups}, grid mu {mu}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text + text2)]
    psnrs = [float(p) for p in re.findall(r"\[TRAIN\] Iter: \d+ Loss: \S+\s+PSNR: (\S+)",
                                          text + text2)]
    it, view, vpsnr, vssim = re.findall(
        r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+) SSIM: (\S+)", text2)[-1]
    white_psnr = -10.0 * math.log10(float(np.mean((1.0 - ds.images[int(view)]) ** 2)))
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    log(f"hashgrid: {steps} + {more} steps in {wall:.1f} s; median "
        f"{statistics.median(rps[1:]):,.0f} rays/s = {ms_step:.2f} ms per step; train PSNR "
        f"{psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB; held-out view {view} at step {it}: "
        f"{float(vpsnr):.2f} dB (SSIM {vssim}), all-white {white_psnr:.2f} dB; "
        f"launches {launches}")
    if not float(vpsnr) >= white_psnr + 2.0:
        raise AssertionError("hashgrid held-out PSNR is not 2 dB above all-white")

    zero_counts()
    _, text3 = run_train_cli(base + ["--N_iters", str(total), "--render_only",
                                     "--render_test"])
    render_launches = launch_counts()
    n_test = len(ds.i_test)
    if (render_launches["gather"] != n_test * frame["gather"]
            or render_launches["composite"] != n_test * frame["composite"]
            or sum(render_launches.values()) != n_test * sum(frame.values())):
        raise AssertionError(f"hashgrid render_only launches {render_launches}")

    served = serve_grid(base + ["--port", "0"], ds, frame, profile=profile)
    vertex_gb = check_vertex_chunk(device)
    vertex = phase_vertex(device, scene, lego)
    tri = phase_triplane(device, scene, lego, ds, tri_steps, blocks, profile)
    by_path = {"hashgrid_training": launches, "hashgrid_render_only": render_launches,
               "hashgrid_serving": served["launches"],
               "hashgrid_vertex_training": vertex["launches"], **tri["launches"]}
    return {"ms_per_step": ms_step, "rays_per_s": statistics.median(rps[1:]),
            "train_psnr": psnrs, "val": (int(it), int(view), float(vpsnr), float(vssim)),
            "white_psnr": white_psnr, "frame_ms": served["frame_ms"],
            "frame_err": served["err"], "triplane": tri["summary"],
            "vertex_chunk_peak_gb": vertex_gb,
            "vertex_ms_per_step": vertex["ms_per_step"],
            "launches_by_path": by_path}


def phase_vertex(device, scene, lego, steps=30):
    """The hashgrid at its defaults (vertex layout, L16/F2/T2^19) trained
    ``steps`` steps with configs/lego.txt on phase 6's scene: one fused P1
    and one P2 a pass, so exactly 2 + 2 a step and nothing else."""
    import re

    logs = os.path.join(WORK, "vertex_logs")
    argv = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "hashgrid_vertex_smoke", "--device", device, "--testskip", "1", "--i_print", "5",
            "--i_testset", "0", "--i_video", "0", "--i_img", "0", "--i_weights", "0",
            "--model_type", "hashgrid", "--N_iters", str(steps)]
    zero_counts()
    state, text = run_train_cli(argv)
    launches = launch_counts()
    want = {"gather": 2 * steps, "scatter_add": 2 * steps}
    if ({k: launches[k] for k in want} != want or sum(launches.values()) != 4 * steps
            or state.count != steps):
        raise AssertionError(f"vertex hashgrid training: launches {launches}, expected "
                             f"{want} and nothing else; Adam count {state.count}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text)]
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    log(f"hashgrid at its defaults (vertex L16/F2/T2^19): {steps} steps, median "
        f"{statistics.median(rps[1:]):,.0f} rays/s = {ms_step:.2f} ms per step; launches "
        f"{launches}")
    return {"ms_per_step": ms_step, "launches": launches}


def check_vertex_chunk(device, n=32768):
    """One serving block (32768 rays, 64 + 128 samples, perturb 0) through
    a seeded hashgrid at the family's defaults (vertex layout, L16 / F2 /
    T 2^19): its fused gather holds 6,291,456 x 16 x 8 int32 indices (3.2
    GB) and as many [2]-float rows (6.4 GB). Returns the peak device memory
    in GB; fails unless the maps are finite and one P1 and one B5 launch a
    pass."""
    import torch

    from nerf_shared_tpu_torch.models.hashgrid import HashGrid, HashGridConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig, render_rays

    cfg = HashGridConfig(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)
    model = HashGrid(cfg, device=device, generator=torch.Generator().manual_seed(2))
    o, d, _, vd = lego_rays(n, 64, seed=12, device=device)
    rays = torch.cat([o, d, torch.full_like(o[:, :1], 2.0), torch.full_like(o[:, :1], 6.0),
                      vd], -1)
    rcfg = RenderConfig(perturb=0.0, N_importance=128, N_samples=64, white_bkgd=True,
                        near=2.0, far=6.0, use_pallas=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        ret = render_rays(model.params(), model.params(), rays, rcfg, cfg, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    log(f"vertex L16/F2/T2^19 hashgrid, one {n}-ray block (64 + 128 samples): {ms:.1f} ms, "
        f"peak device memory {peak:.2f} GB, launches {launches}")
    if not (bool(torch.isfinite(ret["rgb_map"]).all())
            and (launches["gather"], launches["composite"]) == (2, 2)):
        raise AssertionError("the vertex-layout block failed")
    return peak


def serve_grid(argv, ds, frame, profile=False):
    """Two requests of one held-out pose through the dense engine of a grid
    checkpoint; the frame against the same engine through the plain
    versions. Returns launches (both requests), frame ms and the error."""
    import numpy as np

    view = int(ds.i_test[0])
    pose = ds.poses[view][:3, :4]
    served = Served(argv, ds=ds)
    eng = served.service.engine
    try:
        zero_counts()
        status, _, body = http(served.base + "/render", {"c2w": pose.tolist(), "fmt": "npy"})
        one = launch_counts()
        status2, _, body2 = http(served.base + "/render",
                                 {"c2w": pose.tolist(), "fmt": "npy"})
        launches = launch_counts()
        info = json.loads(http(served.base + "/info")[2])
    finally:
        served.close()
    img, img2 = np.load(io.BytesIO(body)), np.load(io.BytesIO(body2))
    first_ms, ms = (t * 1e3 for t in served.service._latencies[:2])
    want = {k: frame.get(k, 0) for k in one}
    if (status, status2) != (200, 200) or one != want:
        raise AssertionError(f"grid frame: HTTP {status} {status2}, launches {one}, "
                             f"expected {want}")
    if img.shape != (eng.H, eng.W, 3) or not np.isfinite(img).all() or not np.array_equal(
            img, img2) or info["model_type"] != eng.args.model_type:
        raise AssertionError(f"grid frame: {img.shape}, /info {info}")
    c2w = np.asarray(pose, np.float32)
    rgb_k, acc_k, z_k, _, _ = engine_maps(eng, True, c2w)
    with plain_gathers():
        before = launch_counts()["gather"]
        rgb_u = engine_maps(eng, False, c2w)[0]
        rgb_p, acc_p = plain_fine_pass(eng, c2w, z_k)
        if launch_counts()["gather"] != before:
            raise AssertionError("the plain grid frame launched P1")
    err, n_held, flips = held(rgb_k, acc_k, rgb_p, acc_p)
    same = float(np.abs(rgb_k - img).max())
    log(f"{eng.args.model_type} frame over HTTP: {ms:.1f} ms ({first_ms:.1f} ms the first), "
        f"launches {one} a frame; vs plain versions at the kernel run's depths max err "
        f"{err:.2e} over {n_held}/{acc_k.size} rays ({flips} sentinel "
        f"flips set apart; tol 1e-3; unpinned {float(np.abs(rgb_k - rgb_u).max()):.2e}); "
        f"HTTP frame vs direct render {same:.1e}; vs held-out view {view} "
        f"{psnr(img, ds.images[view]):.2f} dB")
    if not (err <= 1e-3 and same <= 1e-6 and flips <= acc_k.size // 1000):
        raise AssertionError("the grid frame disagrees with the plain versions")
    if profile:
        _profile(f"{eng.args.model_type} frame", lambda: eng.render_poses(pose[None]))
    return {"launches": {k: launches[k] for k in launches}, "frame_ms": [first_ms, ms],
            "err": err}


def phase_triplane(device, scene, lego, ds, steps, blocks, profile=False):
    """The triplane at its defaults (G 256, C 16, vertex) for ``steps``
    steps from G 128 with one upsample milestone at steps // 2, then one
    served frame."""
    import re

    logs = os.path.join(WORK, "triplane_logs")
    half = steps // 2
    base = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "triplane_smoke", "--device", device, "--testskip", "1", "--i_print", "25",
            "--i_testset", "0", "--i_video", "0", "--i_img", "0", "--i_weights",
            str(steps), "--model_type", "triplane", "--triplane_res", "128",
            "--triplane_upsample", f"{half}:256", "--N_iters", str(steps)]
    zero_counts()
    state, text = run_train_cli(base)
    launches = launch_counts()
    want = {"gather": 24 * steps, "scatter_add": 24 * steps}
    if ({k: launches[k] for k in want} != want or sum(launches.values()) != 48 * steps
            or f"[UPSAMPLE] step {half}: planes -> 256^2" not in text
            or state.coarse.cfg.G != 256 or state.count != steps):
        raise AssertionError(f"triplane training: launches {launches}, G {state.coarse.cfg.G}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text)]
    frame = {"gather": 2 * 12 * blocks, "composite": 2 * blocks}
    served = serve_grid(base[:-2] + ["--port", "0"], ds, frame, profile=profile)
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    summary = {"rays_per_s": rps, "ms_per_step": ms_step, "frame_ms": served["frame_ms"],
               "frame_err": served["err"]}
    log(f"triplane: {steps} steps, rays/s {rps}, median {ms_step:.2f} ms per step; "
        f"launches {launches}")
    return {"summary": summary, "launches": {"triplane_training": launches,
                                             "triplane_serving": served["launches"]}}


def _render_llff_view(job):
    """One view of the forward-facing hard scene, written as a PNG (pool
    worker)."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene
    from nerf_shared_tpu_torch.data.images import imwrite_u8

    path, c2w, H, W, focal = job
    img = hard_scene.render_gt(np.asarray(c2w, np.float32), H, W, focal)
    imwrite_u8(path, (img * 255).astype(np.uint8))


def write_llff_scene(root, H=1512, W=2016, n=20, focal_mult=1.2, workers=8):
    """benchmarks/hard_scene.py's forward-facing capture in the LLFF disk
    format, as its write_llff_dataset lays it out: n cameras on a jittered
    5 x 4 grid at z ~ 4 looking at the origin (seed 23), focal 1.2 W, the
    poses as [down, right, back | eye | H, W, focal] columns with the
    views' [near, far] bounds in poses_bounds.npy, and images/imageNNN.png
    (here through the port's PNG codec; views rendered in a spawn-context
    pool)."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene

    rng = np.random.default_rng(23)
    focal = W * focal_mult
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows, jobs = [], []
    for i in range(n):
        gx = (i % 5 - 2) * 0.35 + 0.08 * rng.standard_normal()
        gy = (i // 5 - 1.5) * 0.3 + 0.08 * rng.standard_normal()
        eye = np.array([gx, gy, 4.0 + 0.25 * rng.standard_normal()])
        c2w = hard_scene._look_at(eye)
        jobs.append((os.path.join(root, "images", f"image{i:03d}.png"), c2w.tolist(),
                     H, W, focal))
        disk = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]], axis=1)
        hwf = np.array([[H], [W], [focal]], np.float64)
        d = np.linalg.norm(eye)
        rows.append(np.concatenate([np.concatenate([disk, hwf], axis=1).ravel(),
                                    [max(d - 1.8, 0.5), d + 1.8]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows).astype(np.float64))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_render_llff_view, jobs, chunksize=1)


def gif_image_count(data):
    """The image descriptors of a GIF89a stream, counted by walking its
    blocks (header, screen descriptor and global table, then extension and
    image blocks with their sub-blocks, to the trailer)."""
    if data[:6] != b"GIF89a":
        raise AssertionError(f"not a GIF89a stream: {data[:6]!r}")
    packed = data[10]
    pos = 13 + (3 * (2 << (packed & 7)) if packed & 0x80 else 0)
    count = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:      # extension: introducer, label, sub-blocks
            pos += 2
        elif data[pos] == 0x2C:    # image: descriptor, local table, code size
            count += 1
            packed = data[pos + 9]
            pos += 11 + (3 * (2 << (packed & 7)) if packed & 0x80 else 0)
        else:
            raise AssertionError(f"GIF: unknown block 0x{data[pos]:02x} at byte {pos}")
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return count


def expect_launches(label, got, want):
    """Raise unless launch_counts() ``got`` holds exactly ``want``'s counts
    and no launch of any other kernel."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label}: expected launches {full}, got {got}")


def phase_llff(device, steps=600, more=200):
    """Phase 10: configs/fern.txt on a generated forward-facing capture:
    minify, train, resume, render the held-out views and the spiral video,
    evaluate, serve."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps import eval_cli
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.data.images import minify_images, png_decode
    from nerf_shared_tpu_torch.train.state import lr_at
    from nerf_shared_tpu_torch.utils.metrics import img2mse, mse2psnr

    scene, logs = os.path.join(WORK, "llff_scene"), os.path.join(WORK, "llff_logs")
    t0 = time.perf_counter()
    write_llff_scene(scene)
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    minify_images(scene, 4)
    minify_s = time.perf_counter() - t0
    log(f"phase 10: wrote the 20-view 1512x2016 LLFF scene in {scene_s:.1f} s; "
        f"minify_images x4 -> 378x504 in {minify_s:.1f} s")
    total = steps + more
    base = ["--config", os.path.join(REPO, "configs", "fern.txt"), "--datadir", scene,
            "--basedir", logs, "--expname", "fern_smoke", "--device", device,
            "--factor", "4", "--i_print", "50", "--i_img", "0", "--i_testset", "0",
            "--i_video", "0", "--i_weights", str(steps)]
    after = base + ["--N_iters", str(total)]

    # train and resume: B1 and B2 twice a step, no render kernel
    zero_counts()
    t0 = time.perf_counter()
    _, text = run_train_cli(base + ["--N_iters", str(steps)])
    state2, text2 = run_train_cli(after)
    train_s = time.perf_counter() - t0
    launches = {"llff_training": launch_counts()}
    expect_launches("fern training", launches["llff_training"],
                    {"fused_mlp_points": 2 * total, "fused_mlp_bwd": 2 * total})
    train_lines = re.findall(r"\[TRAIN\] Iter: (\d+) Loss: \S+\s+PSNR: (\S+)\s+rays/sec: (\S+)",
                             text + text2)
    psnrs = [float(p) for _, p, _ in train_lines]
    rps = [float(r.replace(",", "")) for _, _, r in train_lines]
    if "Reloading from" not in text2 or state2.count != total or state2.step != total:
        raise AssertionError(f"resume: reloaded {'Reloading from' in text2}, Adam count "
                             f"{state2.count}, step {state2.step}, expected {total}")
    lr, a = state2.optimizer.param_groups[0]["lr"], config_parser().parse_args(after)
    if abs(lr - lr_at(a.lrate, a.lrate_decay, total - 1)) > 1e-12:
        raise AssertionError(f"resumed lr {lr} is off the schedule")
    if not psnrs or psnrs[-1] <= psnrs[0] + 1.0:
        raise AssertionError(f"train PSNR did not rise: {psnrs}")
    expdir = os.path.join(logs, "fern_smoke")
    tar = torch.load(os.path.join(expdir, f"{total:06d}.tar"), map_location="cpu",
                     weights_only=True)
    st = tar["optimizer_state_dict"]["state"]
    with np.load(os.path.join(expdir, f"{total:06d}.ckpt.npz")) as z:
        npz_count = int(z["opt/count"])
    if not (len(st) == len(state2.parameters()) and int(st[0]["step"]) == total
            and npz_count == total and float(st[0]["exp_avg"].abs().max()) > 0):
        raise AssertionError("checkpoints lack Adam state")
    ms_step = 1e3 * a.N_rand / statistics.median(rps[1:])

    # the held-out views (llffhold 8): B3 and B5 twice a ray block
    args = config_parser().parse_args(after + ["--render_only", "--render_test"])
    ds = load_datasets(args)
    H, W = ds.hwf[:2]
    if (H, W) != (FERN_H, FERN_W) or list(ds.i_test) != [0, 8, 16]:
        raise AssertionError(f"fern frames {H}x{W}, test views {ds.i_test}")
    per_frame = 2 * math.ceil(H * W / args.chunk)
    zero_counts()
    t0 = time.perf_counter()
    outdir, rgbs = tapp.render_only(args, return_rgbs=True, ds=ds)
    render_s = time.perf_counter() - t0
    launches["llff_render_test"] = launch_counts()
    expect_launches("render_only --render_test", launches["llff_render_test"],
                    {"fused_mlp": 3 * per_frame, "composite": 3 * per_frame})

    def view_psnr(a, b):  # as apps/eval_cli.py computes it
        a, b = (torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b))
        return min(float(mse2psnr(img2mse(a, b))), 120.0)

    gts = ds.images[ds.i_test]
    held_out = [view_psnr(r, g) for r, g in zip(rgbs, gts)]
    mean_rgb = ds.images[ds.i_train].reshape(-1, 3).mean(0)
    white = float(np.mean([view_psnr(np.ones_like(g), g) for g in gts]))
    flat = float(np.mean([view_psnr(np.broadcast_to(mean_rgb, g.shape), g) for g in gts]))
    if not np.isfinite(rgbs).all() or not np.mean(held_out) >= max(white, flat) + 2.0:
        raise AssertionError(f"held-out PSNR {held_out} is not 2 dB above the flat "
                             f"frames (white {white:.2f}, mean colour {flat:.2f} dB)")

    # the first view against the plain versions at the kernel run's fine depths
    eng = tapp.build_eval_engine(args, ds=ds)
    c2w = np.asarray(ds.poses[ds.i_test[0]][:3, :4], np.float32)
    rgb_k, acc_k, z_k, _, _ = engine_maps(eng, True, c2w)
    same = float(np.abs(rgb_k - rgbs[0]).max())
    err, n_held, flips = held(rgb_k, acc_k, *plain_fine_pass(eng, c2w, z_k))
    log(f"fern view {ds.i_test[0]} vs the plain versions at the kernel run's depths: max "
        f"err {err:.2e} over {n_held}/{H * W} rays ({flips} sentinel flips set apart; "
        f"tol 1e-3, at most 1 in 1000 flips); the engine's frame vs render_only's {same:.1e}")
    if not (err <= 1e-3 and flips <= H * W // 1000 and same <= 1e-6):
        raise AssertionError("the fern frame disagrees with the plain versions")

    # the 120-pose spiral at --render_factor 4 as video.gif
    args_sp = config_parser().parse_args(after + ["--render_only", "--render_factor", "4"])
    zero_counts()
    t0 = time.perf_counter()
    outdir_sp = tapp.render_only(args_sp, ds=load_datasets(args_sp))
    spiral_s = time.perf_counter() - t0
    launches["llff_spiral"] = launch_counts()
    per_small = 2 * math.ceil((H // 4) * (W // 4) / args.chunk)
    expect_launches("spiral", launches["llff_spiral"],
                    {"fused_mlp": 120 * per_small, "composite": 120 * per_small})
    with open(os.path.join(outdir_sp, "video.gif"), "rb") as f:
        video = f.read()
    n_gif = gif_image_count(video)
    if n_gif != 120:
        raise AssertionError(f"video.gif holds {n_gif} images, not 120")

    # the evaluation CLI on the same checkpoint
    zero_counts()
    report = eval_cli.main(after + ["--eval_out", os.path.join(logs, "eval.json")])
    launches["llff_eval"] = launch_counts()
    gap = abs(report["mean_psnr"] - float(np.mean(held_out)))
    log(f"eval_cli: {report['n_views']} views, mean PSNR {report['mean_psnr']:.4f} dB, "
        f"SSIM {report['mean_ssim']:.4f}; {gap:.1e} dB from render_only's float frames")
    if report["n_views"] != 3 or not gap <= 1e-6:
        raise AssertionError(f"eval_cli report {report}")

    # serve the checkpoint: one held-out pose over HTTP, twice; then through
    # B4 (--fused_composite)
    served = Served(after + ["--port", "0"], ds=ds)
    try:
        zero_counts()
        status, _, body = http(served.base + "/render", {"c2w": c2w.tolist()})
        launches["llff_serving"] = launch_counts()
        status2, _, body2 = http(served.base + "/render", {"c2w": c2w.tolist()})
    finally:
        served.close()
    frame_ms = served.service._latencies[1] * 1e3
    with open(os.path.join(outdir, "000.png"), "rb") as f:
        want_png = png_decode(f.read())
    png = png_decode(body)
    if status != 200 or status2 != 200 or png.shape != (H, W, 3) or not (
            np.array_equal(png, want_png) and body2 == body):
        raise AssertionError(f"served fern frame: {status} {png.shape}, equal to "
                             f"render_only's PNG: {np.array_equal(png, want_png)}")
    expect_launches("served fern frame", launches["llff_serving"],
                    {"fused_mlp": per_frame, "composite": per_frame})
    mask = frame_mask(eng, c2w)
    served = Served(after + ["--port", "0", "--fused_composite", "True"], ds=ds)
    try:
        zero_counts()
        status, _, body = http(served.base + "/render", {"c2w": c2w.tolist(), "fmt": "npy"})
        launches["llff_fused_composite"] = launch_counts()
    finally:
        served.close()
    fused = np.load(io.BytesIO(body))
    ferr = float(np.abs(fused - rgbs[0])[mask].max())
    log(f"fern fused-composite frame: {served.service._latencies[0] * 1e3:.0f} ms, max err "
        f"vs render_only {ferr:.2e} over {int(mask.sum())}/{mask.size} pixels clear of "
        "the sentinel (tol 1e-3)")
    expect_launches("fused-composite fern frame", launches["llff_fused_composite"],
                    {"fused_mlp": per_frame // 2, "fused_render": per_frame // 2,
                     "composite": per_frame // 2})
    if status != 200 or not ferr <= 1e-3:
        raise AssertionError("the fused-composite fern frame disagrees")

    log(f"phase 10 fern: step {ms_step:.1f} ms (median of {len(rps) - 1} [TRAIN] windows, "
        f"N_rand {a.N_rand}, {a.N_samples} + {a.N_importance} samples), frame "
        f"{frame_ms:.1f} ms ({W}x{H}, served, "
        f"{per_frame} launches), held-out PSNR {np.mean(held_out):.2f} dB over 3 views "
        f"(white {white:.2f}, mean colour {flat:.2f} dB); train PSNR {psnrs[0]:.2f} -> "
        f"{psnrs[-1]:.2f} dB; {steps} + {more} steps in {train_s:.1f} s, 3 test views in "
        f"{render_s:.1f} s, 120-frame spiral in {spiral_s:.1f} s")
    return {"ms_per_step": ms_step, "frame_ms": frame_ms,
            "held_out_psnr": held_out, "white_psnr": white, "mean_colour_psnr": flat,
            "train_psnr": psnrs, "eval": {k: report[k] for k in ("mean_psnr", "mean_ssim")},
            "scene_s": scene_s, "minify_s": minify_s, "train_s": train_s,
            "render_test_s": render_s, "spiral_s": spiral_s, "launches_by_path": launches,
            "engine": eng, "pose": c2w, "argv": after}


POSE_RAYS = 512   # the pose app's batch (--batch_size): 32,768 + 98,304 points a step


def pose_route_cfgs(rcfg):
    """The pose step's three routes from the renderer's config: "kernels"
    (B1 forward + B2 backward, B5 composite: --fused_backward, the card's
    default), "b3" (the renderer's own: B3 forward with its plain remat
    backward, B5; --fused_backward false) and "plain" (apply_nerf and
    raw2outputs under autograd). No sigma noise in any."""
    import dataclasses

    base = dataclasses.replace(rcfg, raw_noise_std=0.0, fused_composite=False)
    return {"kernels": dataclasses.replace(base, fused_backward=True),
            "b3": base,
            "plain": dataclasses.replace(base, use_pallas=False)}


def pose_gradients(cfgs, rcfg, mode, coords, image, start, mparams, pcfg, ov, seed=4,
                   dtype=None):
    """(loss, {name: gradient}, step ms) of one pose step from the same
    initial pose parameters (``seed``) and the same pinned draws ``ov``;
    ``dtype`` float64 runs it with every input in float64 (not timed)."""
    import torch

    from nerf_shared_tpu_torch.apps.pose_estimation import init_pose_params, make_pose_opt_step

    new_opt, step = make_pose_opt_step(rcfg, cfgs[0], cfgs[1], pcfg)
    pp = init_pose_params(torch.Generator().manual_seed(seed), mode, image.device)
    if dtype is not None:
        pp = {k: v.detach().to(dtype).requires_grad_(True) for k, v in pp.items()}
        mparams = {b: {k: v.to(dtype) for k, v in sd.items()} for b, sd in mparams.items()}
        image, start = image.to(dtype), start.to(dtype)
        ov = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in ov.items()}
    opt = new_opt(pp)
    with default_dtype(dtype or torch.float32):
        loss = float(step(pp, opt, coords, image, start, mparams, torch.Generator(),
                          overrides=ov))
    grads = {k: v.grad.detach().clone() for k, v in pp.items()}
    if dtype is not None:
        return loss, grads, None
    ms = time_ms(lambda: step(pp, opt, coords, image, start, mparams, torch.Generator(),
                              overrides=ov), 5)
    return loss, grads, ms


def phase_pose(device, trained):
    """Phase 11: camera poses on phase 6's scene and checkpoint (8x256
    MLPs, 64 + 128 samples): B1 / B2 / B5 at the pose step's shapes, one
    pose step's gradients through each route, one training step with the
    pose flags against the plain step, recovery of a perturbed pose, the
    pose CLI, and the trainer with the pose flags, resumed."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps import pose_cli
    from nerf_shared_tpu_torch.apps.pose_estimation import (
        PoseOptConfig, estimate_relative_pose, init_pose_params, interest_region_coords,
        make_pose_opt_step)
    from nerf_shared_tpu_torch.apps.train import build_eval_engine
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.factory import get_train_state
    from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

    t_phase = time.perf_counter()
    base = trained["base_argv"]
    eng = build_eval_engine(config_parser().parse_args(base))
    ds, K, H, W = eng.ds, eng.K, eng.H, eng.W
    cfgs = (eng.ccfg, eng.fcfg)
    mparams = {"coarse": {k: v.detach() for k, v in eng.coarse.params().items()},
               "fine": {k: v.detach() for k, v in eng.fine.params().items()}}
    routes = pose_route_cfgs(eng.renderer.cfg)

    # B1 / B2 / B5 at the pose step's shapes against their plain versions
    cases = []
    for S in (64, 192):
        cases += train_kernel_cases(eng.fcfg, mparams["fine"], POSE_RAYS, S, lego_rays,
                                    "pose step, phase 6's weights", device, 2e-4, 1e-3)
        cases.append(composite_case(POSE_RAYS, S, "pose step", device))
    for c in cases:
        c["path"] = "pose"

    # the model's own render of a test view: the observed image
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :4] = ds.poses[ds.i_test[0]][:3, :4]
    rgb = eng.render_poses(gt[None, :3, :4])[0]
    obs = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    start_np = (pose_cli.perturbation_matrix(3, 0, 4, 0.1) @ gt).astype(np.float32)
    coords_np = interest_region_coords(obs)
    coords = torch.as_tensor(coords_np, device=device)
    image = torch.as_tensor(obs.astype(np.float32) / 255.0, device=device)
    start = torch.as_tensor(start_np, device=device)
    pcfg = PoseOptConfig.from_K(H, W, K, batch_size=POSE_RAYS, lrate=0.01, n_steps=300)

    # (a) one pose step's loss and pose gradients through each route, the
    # same pixels and stratified depths pinned
    g = torch.Generator().manual_seed(31)
    ov = {"idx": torch.randint(0, len(coords_np), (POSE_RAYS,), generator=g),
          "t_rand": torch.rand(POSE_RAYS, 64, generator=g).to(device),
          "u": torch.rand(POSE_RAYS, 128, generator=g).to(device)}
    step_ms, grad_errs = {}, {}
    for mode in ("screw", "se3"):
        res = {r: pose_gradients(cfgs, c, mode, coords, image, start, mparams, pcfg, ov)
               for r, c in routes.items()}
        res["f64"] = pose_gradients(cfgs, routes["plain"], mode, coords, image, start,
                                    mparams, pcfg, ov, dtype=torch.float64)
        ref = res["f64"][1]
        for r in ("kernels", "b3"):
            loss_err = abs(res[r][0] - res["plain"][0]) / abs(res["plain"][0])
            vs_plain = max(rel_err(res[r][1][k], res["plain"][1][k]) for k in ref)
            held = {k: camera_held(res[r][1][k], res["plain"][1][k], ref[k]) for k in ref}
            grad_errs[(mode, r)] = (loss_err, vs_plain, held)
            f64_err = {x: abs(res[x][0] - res["f64"][0]) / abs(res["f64"][0])
                       for x in (r, "plain")}
            log(f"  pose step {mode} {r}: loss rel err {loss_err:.1e} vs plain (tol 1e-5, or "
                f"against the plain route in float64 max(1e-5, plain fp32's)), vs float64 "
                f"{f64_err[r]:.1e} (plain fp32 {f64_err['plain']:.1e}); "
                f"pose gradients {vs_plain:.1e} of max|grad| from the plain fp32 route; "
                f"against the plain route in float64 "
                + ", ".join(f"{k} {e_k:.1e} (plain fp32 {e_p:.1e})"
                            for k, (e_k, e_p, _) in held.items())
                + f" of max|grad| (tol max({CAMERA_FLOOR:g}, {CAMERA_FACTOR:g} x plain fp32's)); "
                f"|grad| {', '.join(f'{k} {float(v.abs().max()):.2e}' for k, v in ref.items())}")
            # the loss within 1e-5 of the plain fp32 route's or, where that
            # route is itself further from the plain route in float64, no
            # further from float64 than it (floor 1e-5)
            loss_ok = loss_err <= 1e-5 or f64_err[r] <= max(1e-5, f64_err["plain"])
            if not (loss_ok and all(ok for _, _, ok in held.values())):
                raise AssertionError(f"the pose step's {r} route disagrees with the plain "
                                     f"route ({mode})")
        step_ms[mode] = {r: v[2] for r, v in res.items() if r != "f64"}
    # the share of the kernel route's step in each kernel (the profiler;
    # reported only: it has recorded no device time for short kernels)
    new_opt_k, step_k = make_pose_opt_step(routes["kernels"], *cfgs, pcfg)
    pp = init_pose_params(torch.Generator().manual_seed(4), "screw", device)
    opt = new_opt_k(pp)
    parts = kernels_ms(lambda: step_k(pp, opt, coords, image, start, mparams,
                                      torch.Generator(), overrides=ov), 5,
                       ("nerf_points_tc_kernel", "nerf_bwd_kernel", "nerf_dw_kernel",
                        "grad_reduce_kernel", "composite_kernel"))

    # (b) one training step with the pose flags (twists, appearance, BARF
    # mid-ramp, past --refine_poses_from) through the kernels and the plain path
    refine = check_train_step(device, "refine")

    # (c) recovery of the perturbed pose through the kernel route
    zero_counts()
    t0 = time.perf_counter()
    pose, hist = estimate_relative_pose(mparams, *cfgs, routes["kernels"], obs, start_np,
                                        K, pcfg, obs_img_pose=gt,
                                        sampling_strategy="interest_region", seed=0)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    pose_launches = launch_counts()
    # the loss reads the fine pass alone (as the JAX app's): the coarse pass
    # reaches it only through the detached fine depths, so B2 runs for the
    # fine network only, once a step
    expect_launches("pose recovery", pose_launches,
                    {"fused_mlp_points": 600, "fused_mlp_bwd": 300, "composite": 600})
    first, last = hist[0], hist[-1]
    log(f"pose recovery (300 steps, {POSE_RAYS} rays of {len(coords_np)} interest-region "
        f"pixels): loss {first['loss']:.5f} -> {last['loss']:.5f}, rotation error "
        f"{first['rot_error_deg']:.4f} -> {last['rot_error_deg']:.4f} deg, translation "
        f"error {first['translation_error']:.5f} -> {last['translation_error']:.5f}; "
        f"{recover_s:.1f} s ({1e3 * recover_s / 300:.1f} ms a step, interest region and "
        f"history included); launches {pose_launches}")
    if not all(last[k] < first[k] for k in ("loss", "rot_error_deg", "translation_error")):
        raise AssertionError(f"pose recovery did not improve: {first} -> {last}")

    # (d) the pose CLI as a user runs it, on the scene's test image
    zero_counts()
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        cli_pose, cli_hist = pose_cli.main(base + ["--pose_n_steps", "100",
                                                   "--delta_theta", "4", "--delta_t", "0.1"])
    cli_launches = launch_counts()
    expect_launches("pose_cli", cli_launches,
                    {"fused_mlp_points": 200, "fused_mlp_bwd": 100, "composite": 200})
    cli_errs = [(h["rot_error_deg"], h["translation_error"]) for h in (cli_hist[0], cli_hist[-1])]
    if not (np.isfinite(cli_pose).all() and np.isfinite(cli_errs).all()
            and "pose step: kernels B1" in tee.buf.getvalue()):
        raise AssertionError(f"pose_cli: pose {cli_pose}, errors {cli_errs}")
    log(f"pose_cli (100 steps, the test image of the scene): rotation error "
        f"{cli_errs[0][0]:.4f} -> {cli_errs[1][0]:.4f} deg, translation error "
        f"{cli_errs[0][1]:.5f} -> {cli_errs[1][1]:.5f}; launches {cli_launches}")

    # (e) the trainer with the pose flags for 150 + 50 steps, one eval frame
    # mid-anneal at step 100
    argv = [a if a != "lego_smoke" else "lego_pose" for a in base] + [
        "--refine_poses", "True", "--appearance", "True", "--barf_anneal", "400",
        "--refine_poses_from", "100", "--i_img", "100", "--i_weights", "150",
        "--i_print", "25"]
    zero_counts()
    state1, text1 = run_train_cli(argv + ["--N_iters", "150"])
    state2, text2 = run_train_cli(argv + ["--N_iters", "200"])
    train_launches = launch_counts()
    blocks = 2 * math.ceil(H * W / eng.args.chunk)
    expect_launches("pose-flag training", train_launches,
                    {"fused_mlp_points": 400, "fused_mlp_bwd": 400, "fused_mlp": 2 * blocks,
                     "composite": 2 * blocks})
    expdir = os.path.join(base[base.index("--basedir") + 1], "lego_pose")
    tw1 = state1.pose_twists.detach()
    with np.load(os.path.join(expdir, "000150.ckpt.npz")) as z:
        labels = sorted(gr["label"] for gr in state1.optimizer.param_groups)
        gi = {lab: i for i, lab in enumerate(labels)}
        saved_ok = (np.array_equal(z["params/pose_twists"], tw1.cpu().numpy())
                    and np.abs(z[f"opt/g{gi['pose']}/nu/pose_twists"]).max() > 0
                    and np.abs(z[f"opt/g{gi['appearance']}/mu/appearance/gain"]).max() > 0
                    and int(z[f"opt/g{gi['pose']}/count"]) == 150)
    fresh = get_train_state(config_parser().parse_args(argv), device, cfgs=cfgs,
                            n_refine_poses=len(ds.i_train), n_appearance=len(ds.i_train))
    ckpt_utils.restore_train_state(fresh, config_parser().parse_args(
        argv + ["--ft_path", os.path.join(expdir, "000150.ckpt.npz")]))
    restored = all(torch.equal(fresh.aux[k], state1.aux[k].detach()) and torch.equal(
        fresh.optimizer.state[fresh.aux[k]]["exp_avg_sq"],
        state1.optimizer.state[state1.aux[k]]["exp_avg_sq"]) for k in state1.aux)
    vals = re.findall(r"\[VAL\] Iter: (\d+) view \d+ PSNR: (\S+)", text1 + text2)
    rps = [float(r.replace(",", "")) for r in re.findall(r"rays/sec: (\S+)", text1 + text2)]
    refine_ms = 1e3 * eng.args.N_rand / statistics.median(rps[1:])
    log(f"pose-flag training: twists RMS {float(tw1.square().mean().sqrt()):.2e} at step 150 "
        f"(image 0's {float(tw1[0].abs().max()):.1e}), gains RMS "
        f"{float(state1.appearance['gain'].detach().square().mean().sqrt()):.2e}; the .ckpt.npz "
        f"carries both groups and their moments: {saved_ok}; restored exactly: {restored}; "
        f"eval frames {vals}; step {refine_ms:.1f} ms (median of {len(rps) - 1} [TRAIN] "
        f"windows); launches {train_launches}")
    if not (float(tw1[1:].abs().max()) > 0 and float(tw1[0].abs().max()) == 0 and saved_ok
            and restored and "000150.ckpt.npz" in text2 and "Adam moments" not in text2
            and state2.count == 200 and [v[0] for v in vals] == ["100", "200"]):
        raise AssertionError("the trainer with the pose flags failed a check")

    k_ms = step_ms["screw"]
    log(f"phase 11 pose: pose step {k_ms['kernels']:.2f} ms through B1 + B2 + B5, "
        f"{k_ms['b3']:.2f} ms through B3 + B5, {k_ms['plain']:.2f} ms plain ({POSE_RAYS} "
        f"rays, 64 + 128 samples, median of 5); nerf_dw_kernel "
        f"{parts['nerf_dw_kernel'] or 0:.3f} ms of it (profiler); refine step "
        f"{refine['kernel_ms']:.2f} ms kernels, {refine['plain_ms']:.2f} ms plain; "
        f"recovery rotation {first['rot_error_deg']:.4f} -> {last['rot_error_deg']:.4f} deg, "
        f"translation {first['translation_error']:.5f} -> {last['translation_error']:.5f}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"cases": cases, "step_ms": step_ms, "kernel_parts_ms": parts,
            "grad_errs": {f"{m} {r}": {"loss": v[0], "vs_plain": v[1], "vs_f64": {
                k: e[:2] for k, e in v[2].items()}} for (m, r), v in grad_errs.items()},
            "refine_step": refine, "refine_train_ms": refine_ms,
            "recovery": {"first": first, "last": last, "s": recover_s},
            "cli": cli_errs, "launches_by_path": {
                "pose": pose_launches, "pose_cli": cli_launches,
                "pose_training": train_launches}}


# the four flags of phase 12, the JAX package's quality-first recipe
PROPOSAL_FLAGS = ["--proposal", "True", "--loss_sampling", "True", "--ema_decay", "0.99",
                  "--distortion_loss_weight", "0.01"]


def proposal_step_setup(device, fused, loss_sampling=True):
    """The lego step with the four flags: a seeded 2x64 density-only
    proposal MLP (plain) as the coarse branch, the 8x256 fine MLP (B1 + B2
    when ``fused``), two 400x400 seeded images, N_rand 1024, 64 proposal +
    128 importance samples, the state at step 600 (past the precrop
    window, so the weighted tail is drawn), an EMA shadow at decay 0.99 and
    a seeded peaked loss map [2, 50, 50]. Returns (state, step, images,
    poses, overrides, draws): the stratified and inverse-CDF draws, image
    1, its permutation keys and the weighted tail's tile uniforms and
    jitter, pinned."""
    import torch

    from nerf_shared_tpu_torch.data.poses import pose_spherical
    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.loss_sampling import LossSamplingSpec
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    ccfg = NeRFConfig(D=2, W=64, output_ch=4, skips=(4,), use_viewdirs=False,
                      multires=10, multires_views=4)
    fcfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                      multires_views=4, output_ch=5)
    g = torch.Generator().manual_seed(23)
    H = W = 400
    focal = 0.5 * H / math.tan(0.5 * 0.6911112)
    K = [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]]
    poses = torch.stack([torch.as_tensor(pose_spherical(a, -30.0, 4.0)[:3, :4])
                         for a in (0.0, 120.0)]).float().to(device)
    images = torch.rand(2, H, W, 3, generator=g).to(device)
    spec = PixelSamplerSpec.from_K(H, W, K, 1024, single_image=True, precrop_iters=500,
                                   precrop_frac=0.5)
    rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64, use_viewdirs=True,
                        white_bkgd=True, near=2.0, far=6.0, fused_backward=fused,
                        proposal=True)
    state = create_train_state(ccfg, fcfg, device, seed=3, lrate=5e-4, lrate_decay=500)
    state.step = 600
    state.init_ema()
    state.loss_map = (torch.rand(2, 50, 50, generator=g) ** 4).to(device)
    overrides = {"t_rand": torch.rand(1024, 64, generator=g).to(device),
                 "u": torch.rand(1024, 128, generator=g).to(device)}
    draws = {"img_idx": 1, "key_y": torch.randint(0, 1 << 32, (2,), generator=g),
             "key_x": torch.randint(0, 1 << 32, (2,), generator=g),
             "tile_u": torch.rand(1024, generator=g),
             "jitter_y": torch.randint(0, 8, (1024,), generator=g),
             "jitter_x": torch.randint(0, 8, (1024,), generator=g)}
    step = make_train_step(rcfg, ccfg, fcfg, spec, prop_reg=1.0, dist_reg=0.01,
                           loss_sampling=LossSamplingSpec() if loss_sampling else None,
                           ema_decay=0.99)
    return state, step, images, poses, overrides, draws


def count_syncs(fn):
    """Host syncs ``fn`` makes, as torch.cuda.set_sync_debug_mode("warn")
    reports them: (count, the sorted "file:line" of each)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = sorted(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message))
    return len(where), where


def check_proposal_step(device):
    """Phase 12 (a): one step with the four flags at full width through B1
    + B2 and through the plain path from the same state and draws: the loss
    and its parts within 1e-5, every gradient (proposal and fine) within
    1e-3 of its max, the post-Adam parameters as phase 5 holds them
    (adam_checks), the EMA shadow (each route's equal to 0.99 e0 + 0.01 p
    to 1e-6, the routes apart by at most 0.01 x their parameters' gap +
    1e-6) and the updated loss map within 1e-5 of its max. Exactly one B1
    and one B2 launch on the kernel route, none on the plain one. Then the
    host syncs of an unpinned loss-sampling step against a uniform step's
    (the tail is drawn and the map updated on the card: it must add none).
    Returns times and errors."""
    import torch

    out = {}
    dec = ReluDecisions()
    for fused in (True, False):
        state, step, images, poses, ov, draws = proposal_step_setup(device, fused)
        e0 = [state.ema[b][n].clone() for (b, n) in state.named_parameters()]
        lmap0 = state.loss_map.clone()
        params = state.parameters()
        before = launch_counts()
        with dec.record() if fused else dec.replay():
            aux = step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                       overrides=ov)
        torch.cuda.synchronize()
        after = launch_counts()
        out[fused] = dict(aux={k: float(v) for k, v in aux.items()},
                          launched={k: after[k] - before[k] for k in after},
                          grads=[p.grad.detach().clone() for p in params],
                          params=[p.detach().clone() for p in params],
                          ema=[state.ema[b][n].clone() for (b, n) in state.named_parameters()],
                          e0=e0, lmap=state.loss_map.clone(), lmap0=lmap0,
                          names=list(state.named_parameters()),
                          lrs=[gr["lr"] for gr in state.optimizer.param_groups
                               for _ in gr["params"]])

        def again():
            step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                 overrides=ov)

        out[fused]["ms"] = time_ms(again, 3)
    k, p = out[True], out[False]
    expect_launches("proposal step, kernels", k["launched"],
                    {"fused_mlp_points": 1, "fused_mlp_bwd": 1})
    expect_launches("proposal step, plain", p["launched"], {})
    part_err = {n: abs(k["aux"][n] - p["aux"][n]) / abs(p["aux"][n])
                for n in ("loss", "img_loss", "prop_loss", "dist_loss")}
    grad_err = {b: max(rel_err(gk, gp) for (bb, _), gk, gp in zip(k["names"], k["grads"],
                                                                    p["grads"]) if bb == b)
                for b in ("coarse", "fine")}
    param_err, adam_err, moved, moved_tol, moved_g, n_sure, n_par = adam_checks(k, p)
    blend_err = max(float((e - (0.99 * e0 + 0.01 * q)).abs().max())
                    for r in (k, p) for e, e0, q in zip(r["ema"], r["e0"], r["params"]))
    ema_gap = max(float(((ek - ep).abs() - 0.01 * (qk - qp).abs()).max())
                  for ek, ep, qk, qp in zip(k["ema"], p["ema"], k["params"], p["params"]))
    lmap_err = rel_err(k["lmap"], p["lmap"])
    lmap_moved = int((k["lmap"] != k["lmap0"]).sum())

    # host syncs: an unpinned loss-sampling step against a uniform one
    syncs, sites = {}, {}
    for name, ls in (("uniform", False), ("loss_sampling", True)):
        state, step, images, poses, _, _ = proposal_step_setup(device, True, loss_sampling=ls)
        gen = torch.Generator().manual_seed(5)
        step(state, images, poses, gen)   # warm-up
        syncs[name], sites[name] = count_syncs(lambda: step(state, images, poses, gen))
    log(f"proposal step (lego, --proposal --loss_sampling --ema_decay 0.99 "
        f"--distortion_loss_weight 0.01; N_rand 1024, 64 proposal + 128 importance samples, "
        f"2x64 proposal plain, 8x256 fine 196,608 points): kernels {k['ms']:.2f} ms, plain "
        f"{p['ms']:.2f} ms; launches {k['launched']}; loss parts rel err "
        + ", ".join(f"{n} {e:.1e}" for n, e in part_err.items()) + " (tol 1e-5); worst "
        f"gradient proposal {grad_err['coarse']:.1e}, fine {grad_err['fine']:.1e} of max|grad| "
        f"(tol 1e-3){dec.note()}; post-Adam params {param_err:.1e} (tol 1e-6) on {n_sure} of "
        f"{n_par}, "
        f"{adam_err:.1e} from Adam's update (tol 1e-6), {moved} moved apart (tol "
        f"{moved_tol}, largest |grad| {moved_g:.1e} of max); EMA blend err {blend_err:.1e}, "
        f"routes' EMA gap beyond 0.01 x params' {ema_gap:.1e} (tol 1e-6); loss map "
        f"{lmap_err:.1e} of max (tol 1e-5), {lmap_moved} tiles updated; host syncs a step: "
        f"uniform {syncs['uniform']} {sites['uniform']}, loss sampling "
        f"{syncs['loss_sampling']} {sites['loss_sampling']}")
    if not (all(e <= 1e-5 for e in part_err.values())
            and all(e <= 1e-3 for e in grad_err.values()) and param_err <= 1e-6
            and adam_err <= 1e-6 and moved <= moved_tol and blend_err <= 1e-6
            and ema_gap <= 1e-6 and lmap_err <= 1e-5 and lmap_moved > 0
            and syncs["loss_sampling"] <= syncs["uniform"]):
        raise AssertionError("the proposal step through the kernels disagrees with the "
                             "plain step, or loss sampling added host syncs")
    return {"kernel_ms": k["ms"], "plain_ms": p["ms"], "part_err": part_err,
            "grad_err": grad_err, "param_err": param_err, "adam_err": adam_err,
            "moved": moved, "ema_blend_err": blend_err, "ema_gap": ema_gap,
            "lmap_err": lmap_err, "syncs": syncs}


def phase_proposal(device, trained, smi, steps=400, more=100, mixed_steps=100):
    """Phase 12: --proposal --loss_sampling --ema_decay 0.99
    --distortion_loss_weight 0.01 with configs/lego.txt on phase 6's scene
    (--precrop_iters 100, so most steps draw the weighted tail): (a) one
    step against the plain step (check_proposal_step); (b) apps/train.main
    for ``steps`` + ``more`` steps: exactly one B1 and one B2 a step, no
    B3 while training (the one [VAL] frame at the end: 5 B3 + 10 B5, the
    proposal plain), train PSNR rising, the ema/ sidecar in the .ckpt.npz
    restored exactly, the loss map off uniform; --render_only
    --render_test (5 B3 + 10 B5 a frame; the frame within 1e-3 of the plain
    renderer on the EMA weights at the kernel run's fine depths, and apart
    from the raw weights' frame; held-out PSNR >= 2 dB above all-white);
    one frame served over HTTP through --render_guided 48 (/info "ema"
    true); --render_gate refused; (c) the mixed hierarchy (the proposal
    coarse + the split L8/F8/T14 hashgrid fine) for ``mixed_steps`` steps:
    exactly 8 P1 + 8 P2 a step and nothing else, the tables' Adam group at
    --grid_lrate, and one served frame against its plain versions."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.apps.train import build_eval_engine
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.factory import get_train_state
    from nerf_shared_tpu_torch.train.state import lr_at
    from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

    t_phase = time.perf_counter()
    step_check = check_proposal_step(device)

    # (b) the trainer, resumed, render_only, served
    total = steps + more
    argv = [a if a != "lego_smoke" else "lego_proposal" for a in trained["base_argv"]] + (
        PROPOSAL_FLAGS + ["--precrop_iters", "100", "--i_img", str(total), "--i_weights",
                          str(steps), "--i_print", "50"])
    args = config_parser().parse_args(argv)
    expdir = os.path.join(args.basedir, args.expname)
    serve_argv = argv + ["--N_iters", str(total), "--port", "0"]
    ds = load_datasets(serve_parser().parse_args(serve_argv))
    blocks = math.ceil(ds.hwf[0] * ds.hwf[1] / args.chunk)
    zero_counts()
    state1, text1 = run_train_cli(argv + ["--N_iters", str(steps)])
    first = launch_counts()
    expect_launches("proposal training (first run)", first,
                    {"fused_mlp_points": steps, "fused_mlp_bwd": steps})
    with np.load(os.path.join(expdir, f"{steps:06d}.ckpt.npz")) as z:
        ema_keys = [n for n in z.files if n.startswith("ema/")]
        saved = np.array_equal(z["ema/fine/pts_linears/0/w"],
                               state1.ema["fine"]["pts_linears.0.weight"].T.cpu().numpy())
    fresh = get_train_state(args, device)
    fresh.init_ema()
    ckpt_utils.restore_train_state(fresh, args)
    restored = all(torch.equal(fresh.ema[b][n], state1.ema[b][n])
                   for b in state1.ema for n in state1.ema[b])
    state2, text2 = run_train_cli(argv + ["--N_iters", str(total)])
    launches = launch_counts()
    expect_launches("proposal training", launches,
                    {"fused_mlp_points": total, "fused_mlp_bwd": total, "fused_mlp": blocks,
                     "composite": 2 * blocks})
    train_lines = re.findall(r"\[TRAIN\] Iter: \d+ Loss: \S+\s+PSNR: (\S+)\s+rays/sec: (\S+)",
                             text1 + text2)
    psnrs = [float(a) for a, _ in train_lines]
    rps = [float(b.replace(",", "")) for _, b in train_lines]
    train_ms = 1e3 * args.N_rand / statistics.median(rps[1:])
    it, view, vpsnr, vssim = re.findall(r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+) SSIM: (\S+)",
                                        text2)[-1]
    lm = state2.loss_map
    lmap_spread = float(lm.max() / lm.min())
    log(f"proposal training: {steps} + {more} steps, median {statistics.median(rps[1:]):,.0f} "
        f"rays/s = {train_ms:.2f} ms a step; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB; "
        f"{len(ema_keys)} ema/ keys in the .ckpt.npz (the shadow as trained: {saved}), "
        f"restored exactly: {restored}; loss map max/min {lmap_spread:.1f} at the end; "
        f"launches {launches}")
    if not (len(ema_keys) == len(state1.parameters()) and saved and restored
            and f"{steps:06d}.ckpt.npz" in text2 and psnrs[-1] > psnrs[0] + 1.0
            and state2.count == total and float((lm - 1.0).abs().max()) > 1e-3):
        raise AssertionError("the proposal trainer failed a check")

    eng = build_eval_engine(serve_parser().parse_args(serve_argv), ds=ds)
    white = -10.0 * math.log10(float(np.mean((1.0 - ds.images[int(view)]) ** 2)))
    zero_counts()
    _, text3 = run_train_cli(argv + ["--N_iters", str(total), "--render_only",
                                     "--render_test"])
    render_launches = launch_counts()
    n_test = len(ds.i_test)
    expect_launches("proposal render_only", render_launches,
                    {"fused_mlp": n_test * blocks, "composite": n_test * 2 * blocks})
    sidecar = ckpt_utils.read_native_ema(os.path.join(expdir, f"{total:06d}.ckpt.npz"))
    is_ema = all(torch.equal(v.cpu(), sidecar[b][n])
                 for b, m in (("coarse", eng.coarse), ("fine", eng.fine))
                 for n, v in m.state_dict().items())
    c2w = np.asarray(ds.poses[ds.i_test[0]][:3, :4], np.float32)
    t0 = time.perf_counter()
    rgb_k, acc_k, z_k, _, _ = engine_maps(eng, True, c2w)
    frame_ms = 1e3 * (time.perf_counter() - t0)
    err, n_held, flips = held(rgb_k, acc_k, *plain_fine_pass(eng, c2w, z_k))
    raw_eng = build_eval_engine(serve_parser().parse_args(
        [a for a in serve_argv if a not in ("--ema_decay", "0.99")]), ds=ds)
    raw_gap = float(np.abs(engine_maps(raw_eng, True, c2w)[0] - rgb_k).max())
    log(f"proposal render_only: {n_test} views, launches {render_launches}; the engine holds "
        f"the EMA sidecar: {is_ema}; test view 0 vs the plain renderer on the EMA weights at "
        f"the kernel run's depths {err:.2e} over {n_held}/{acc_k.size} rays ({flips} sentinel "
        f"flips set apart; tol 1e-3); vs the raw weights' frame {raw_gap:.2e}; held-out view "
        f"{view} at step {it}: {float(vpsnr):.2f} dB (SSIM {vssim}), all-white {white:.2f} dB")
    if not (is_ema and err <= 1e-3 and flips <= acc_k.size // 1000 and raw_gap > 1e-3
            and float(vpsnr) >= white + 2.0):
        raise AssertionError("the proposal render failed a check")

    served = Served(serve_argv + ["--render_guided", "48"], ds=ds)
    try:
        zero_counts()
        status, _, body = http(served.base + "/render", {"c2w": c2w.tolist(), "fmt": "npy"})
        served_launches = launch_counts()
        info = json.loads(http(served.base + "/info")[2])
    finally:
        served.close()
    img = np.load(io.BytesIO(body))
    g_eng = served.service.engine
    served_ms = served.service._latencies[0] * 1e3
    expect_launches("proposal guided frame", served_launches,
                    {"fused_mlp": blocks, "composite": 2 * blocks})
    kern = engine_maps(g_eng, True, c2w)
    checks, _, _, note = frame_checks(g_eng, c2w, kern)
    g_err, g_held, g_flips = checks["at the kernel run's depths"]
    same = float(np.abs(kern[0] - img).max())
    gate_eng = build_eval_engine(serve_parser().parse_args(serve_argv + ["--render_gate",
                                                                         "1e-3"]), ds=ds)
    try:
        gate_eng.render_poses(c2w[None])
        gate_refused = False
    except ValueError as e:
        gate_refused = "density-only" in str(e)
    log(f"proposal guided 48 frame over HTTP: {served_ms:.1f} ms, launches {served_launches}; "
        f"/info ema {info.get('ema')}, engine {info.get('engine')}; vs plain at the kernel "
        f"run's depths {g_err:.2e} over {g_held} rays ({g_flips} flips){note}; HTTP vs direct "
        f"{same:.1e}; --render_gate refused: {gate_refused}")
    if not (status == 200 and info.get("ema") is True and info.get("engine") == "dense"
            and g_err <= 1e-3 and g_flips <= img.size // 3000 and same <= 1e-6
            and np.isfinite(img).all() and gate_refused):
        raise AssertionError("the proposal guided frame failed a check")

    # (c) the mixed hierarchy: a proposal MLP coarse + the split hashgrid fine
    m_argv = [a if a != "lego_smoke" else "mixed_proposal" for a in trained["base_argv"]] + (
        GRID_ARGS + ["--proposal", "True", "--i_img", "0", "--i_weights", str(mixed_steps),
                     "--i_print", "25"])
    zero_counts()
    m_state, m_text = run_train_cli(m_argv + ["--N_iters", str(mixed_steps)])
    m_launches = launch_counts()
    expect_launches("mixed hierarchy training", m_launches,
                    {"gather": 8 * mixed_steps, "scatter_add": 8 * mixed_steps})
    groups = {gr["label"]: gr for gr in m_state.optimizer.param_groups}
    tables = {id(t) for t in m_state.fine.tables}
    lr_ok = (abs(groups["grid"]["lr"] - lr_at(2e-2, 500, mixed_steps - 1)) < 1e-12
             and abs(groups["net"]["lr"] - lr_at(5e-4, 500, mixed_steps - 1)) < 1e-12
             and {id(t) for t in groups["grid"]["params"]} == tables
             and isinstance(m_state.coarse.cfg, type(eng.coarse.cfg))
             and m_state.coarse.cfg.W == 64)
    m_rps = [float(r.replace(",", "")) for r in re.findall(r"rays/sec: (\S+)", m_text)]
    m_ms = 1e3 * args.N_rand / statistics.median(m_rps[1:])
    log(f"mixed hierarchy (2x64 proposal + split L8/F8/T14 hashgrid): {mixed_steps} steps, "
        f"{m_ms:.2f} ms a step; launches {m_launches}; the tables' group at "
        f"{groups['grid']['lr']:.3e}, the rest at {groups['net']['lr']:.3e}: {lr_ok}")
    if not lr_ok:
        raise AssertionError("the mixed hierarchy's Adam groups are off")
    m_served = serve_grid(m_argv + ["--N_iters", str(mixed_steps), "--port", "0"], ds,
                          {"gather": 8 * blocks, "composite": 2 * blocks})

    wall = time.perf_counter() - t_phase
    log(f"phase 12 proposal: step {step_check['kernel_ms']:.2f} ms through B1 + B2 "
        f"(plain {step_check['plain_ms']:.2f} ms; phase 6's lego step "
        f"{trained['ms_per_step']:.2f} ms), the trainer {train_ms:.2f} ms a step; dense frame "
        f"{frame_ms:.1f} ms, guided 48 frame {served_ms:.1f} ms; held-out PSNR "
        f"{float(vpsnr):.2f} dB (all-white {white:.2f}); mixed step {m_ms:.2f} ms, frame "
        f"{m_served['frame_ms'][1]:.1f} ms; {wall:.1f} s; {smi}")
    return {"step": step_check, "train_ms": train_ms, "train_psnr": psnrs,
            "val": (int(it), int(view), float(vpsnr), float(vssim)), "white_psnr": white,
            "frame_ms": frame_ms, "frame_err": err, "raw_gap": raw_gap,
            "guided_ms": served_ms, "guided_err": g_err, "mixed_ms": m_ms,
            "mixed_frame_ms": m_served["frame_ms"], "mixed_frame_err": m_served["err"],
            "s": wall, "launches_by_path": {
                "proposal_training": launches, "proposal_render_only": render_launches,
                "proposal_guided_serving": served_launches,
                "mixed_training": m_launches, "mixed_serving": m_served["launches"]}}


# --- phases 13 and 14: the occupancy-gated trainer and mesh export ----------

# --train_occ at its defaults: C 64 candidates, K 32 kept, a 64^3 grid
OCC_FLAGS = ["--train_occ", "True"]


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


class ReluDecisions:
    """B2's ReLU decisions in a kernel training step, for the plain step to
    take (RELU_SWITCH: two fp32 routes switch a unit whose pre-activation
    lies within rounding of 0 each their own way, which moves the field
    gradients below it by up to ~1e-2 of their max). ``record()``: each B2
    launch inside the block runs through launch_backward_h and its
    decisions (relu_masks of its H) are kept by (point count, network), in
    launch order. ``replay()``: inside the block the plain network
    (models.nerf.apply_mlp) of a recorded point count and network runs on
    the first such launch's decisions (masked_mlp) and the plain bf16 B2
    (bf16_plain_versions) takes them; everything else of the plain step is
    its own. ``switches``: how many decisions differ from the plain
    network's own forward (float64), and at what largest |pre-activation|
    as a share of its layer's max."""

    def __init__(self):
        self.masks = {}
        self.switches = (0, 0.0)

    @contextlib.contextmanager
    def record(self):
        import torch

        from nerf_shared_tpu_torch.ops.cuda import fused_mlp_bwd

        def wrap(orig):
            def run(params, cfg, pts, viewdirs, g, compute_dtype=torch.float32, saved=None,
                    dx=True):
                *out, hbuf, n_pad = fused_mlp_bwd.launch_backward_h(params, cfg, pts, viewdirs,
                                                                    g, compute_dtype, saved, dx)
                n = pts.numel() // 3
                masks = relu_masks(cfg, hbuf, n_pad, n)
                self.masks.setdefault((n, cfg), []).append(masks)
                p = params if compute_dtype == torch.bfloat16 else {
                    k: v.detach().double() for k, v in params.items()}
                c, z = relu_switches(cfg, p, pts.detach(), None if viewdirs is None
                                     else viewdirs.detach(), masks,
                                     bf16=compute_dtype == torch.bfloat16)
                self.switches = (self.switches[0] + c, max(self.switches[1], z))
                return tuple(out)
            return run

        with patched(fused_mlp_bwd, "launch_backward", wrap):
            yield

    def replay(self):
        from nerf_shared_tpu_torch.models import nerf as nerf_mod

        def wrap(orig):
            def run(params, cfg, x):
                n = x.numel() // x.shape[-1]
                if (n, cfg) not in self.masks:
                    return orig(params, cfg, x)
                raw = masked_mlp(params, cfg, x.reshape(n, -1),
                                 [m.to(x.dtype) for m in self.masks[(n, cfg)][0]])
                return raw.reshape(x.shape[:-1] + (raw.shape[-1],))
            return run

        return patched(nerf_mod, "apply_mlp", wrap)

    def note(self, limit=RELU_SWITCH):
        """A log line's note on the switched decisions; raises past
        ``limit``."""
        c, z = self.switches
        if z > limit:
            raise AssertionError(f"B2 switched ReLU decisions at |pre-activation| up to "
                                 f"{z:.1e} of the layer's max (tol {limit:g})")
        return (f"; the plain step on B2's ReLU decisions ({c} other than float64's, all "
                f"at |pre-activation| <= {z:.1e} of the layer's max, tol {limit:g})")


def occ_setup(device, trained):
    """Phase 6's scene and 800-step checkpoint under --train_occ: the
    parsed args, dataset, renderer, sampler spec, training images and
    poses on the card, the fine config, the grid's box and alpha."""
    import torch

    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser, resolved_occ_alpha_thresh
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.factory import get_renderer, nerf_configs
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec

    args = config_parser().parse_args(trained["base_argv"] + ["--N_iters", "800"] + OCC_FLAGS)
    ds = load_datasets(args)
    H, W = int(ds.hwf[0]), int(ds.hwf[1])
    renderer = get_renderer(args, ds.bds_dict, device)
    spec = PixelSamplerSpec.from_K(H, W, ds.K, args.N_rand, single_image=args.no_batching,
                                   precrop_iters=args.precrop_iters,
                                   precrop_frac=args.precrop_frac)
    return {"args": args, "ds": ds, "renderer": renderer, "spec": spec,
            "images": torch.as_tensor(ds.images[ds.i_train], device=device),
            "poses": torch.as_tensor(ds.poses[ds.i_train][:, :3, :4], device=device),
            "cfg": nerf_configs(args)[1], "aabb": tapp._occ_aabb(renderer, ds, H, W, ds.K),
            "alpha": resolved_occ_alpha_thresh(args)}


def occ_state(setup, device):
    """A TrainState with phase 6's 800-step weights and a fresh Adam."""
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

    a, cfg = setup["args"], setup["cfg"]
    with contextlib.redirect_stdout(io.StringIO()):
        coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(a)
    state = create_train_state(cfg, cfg, device, lrate=a.lrate, lrate_decay=a.lrate_decay)
    state.coarse.load_state_dict(coarse_sd, strict=True)
    state.fine.load_state_dict(fine_sd, strict=True)
    state.step = state.count = start
    return state


def occ_rcfg(setup, fused, noise):
    """The trainer's step config (apps/train.py): kernels B1 + B2 when
    ``fused``, else the plain network; sigma noise ``noise``."""
    import dataclasses

    return dataclasses.replace(setup["renderer"].cfg, use_pallas=False,
                               fused_composite=False, fused_backward=fused, guided=0,
                               raw_noise_std=noise)


def occ_grid_check(label, dg_k, dg_p, alpha):
    """A density refresh through B1 against the plain one: the EMA within
    2e-4 of max(1, max|plain|), the binarized grids equal apart from cells
    within 1e-4 relative of the threshold. Returns (ema_err, flips, the
    occupied fraction)."""
    import torch

    from nerf_shared_tpu_torch.train.occ_train import binarize_density_grid

    ema_err = float((dg_k.ema - dg_p.ema).abs().max()) / max(1.0, float(dg_p.ema.abs().max()))
    g = dg_p.ema.shape[0]
    step = float(torch.linalg.norm((dg_p.aabb_max - dg_p.aabb_min) / g))
    thr = -math.log1p(-min(alpha, 0.999)) / step
    near = (dg_p.ema - thr).abs() <= 1e-4 * thr
    bk = binarize_density_grid(dg_k, alpha, dilation=0).grid
    bp = binarize_density_grid(dg_p, alpha, dilation=0).grid
    flips = int((bk != bp).sum())
    off = int(((bk != bp) & ~near).sum())
    dk = binarize_density_grid(dg_k, alpha).grid
    dp = binarize_density_grid(dg_p, alpha).grid
    frac = float(dp.float().mean())
    log(f"{label}: EMA through B1 vs plain {ema_err:.1e} of max(1, max|plain|) (tol 2e-4); "
        f"binarized cells apart {flips} ({off} farther than 1e-4 of the threshold, tol 0); "
        f"dilated grids equal: {torch.equal(dk, dp)}; {frac:.1%} occupied")
    if not (ema_err <= 2e-4 and off == 0 and (flips > 0 or torch.equal(dk, dp))):
        raise AssertionError(f"{label}: the kernel refresh disagrees with the plain one")
    return ema_err, flips, frac


def check_occ_step(setup, device, occ, density, noise, label):
    """One occupancy-gated step (make_occ_train_step, 1024 rays, C 64, K 32)
    from phase 6's weights through B1 + B2 and through the plain network,
    the candidates' jitter, the race uniforms, the explore draw and the
    sigma noise pinned: the loss within 1e-5 relative, every fine gradient
    within 1e-3 of its max, the coarse gradients exactly zero, the
    post-Adam parameters as phase 5 holds them. Returns the times (median
    of 5 steps) and errors."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd
    from nerf_shared_tpu_torch.train.occ_train import make_occ_train_step

    a = setup["args"]
    C, K, n = a.train_occ_candidates, a.train_occ_keep, a.N_rand
    g = torch.Generator(device=device).manual_seed(13)
    draws = {"t_rand": torch.rand(n, C, generator=g, device=device),
             "u": torch.rand(n, C, generator=g, device=device) * (1.0 - 1e-7) + 1e-7,
             "explore_u": torch.rand(n, C, generator=g, device=device),
             "noise": torch.randn(n, K, generator=g, device=device) * noise}
    out = {}
    dec = ReluDecisions()
    for fused in (True, False):
        state = occ_state(setup, device)
        step = make_occ_train_step(occ_rcfg(setup, fused, noise), setup["cfg"], setup["spec"],
                                   n_candidates=C, n_keep=K, explore=a.train_occ_explore)
        params = state.parameters()
        before = (fused_mlp.POINT_LAUNCHES, fused_mlp_bwd.LAUNCHES)
        with dec.record() if fused else dec.replay():
            aux = step(state, occ, setup["images"], setup["poses"],
                       torch.Generator().manual_seed(9), density=density, draws=draws)
        torch.cuda.synchronize()
        launched = (fused_mlp.POINT_LAUNCHES - before[0], fused_mlp_bwd.LAUNCHES - before[1])
        n_coarse = len(list(state.coarse.parameters()))
        out[fused] = dict(loss=float(aux["loss"]), n_active=float(aux["n_active_mean"]),
                          launched=launched, n_coarse=n_coarse,
                          coarse_zero=all(not bool(p.grad.any()) for p in params[:n_coarse]),
                          grads=[p.grad.detach().clone() for p in params],
                          params=[p.detach().clone() for p in params],
                          lrs=[gr["lr"] for gr in state.optimizer.param_groups
                               for _ in gr["params"]])

        def again():
            step(state, occ, setup["images"], setup["poses"], torch.Generator().manual_seed(9),
                 density=density, draws=draws)

        out[fused]["ms"] = time_ms(again, 5)
    k, p = out[True], out[False]
    nc = k["n_coarse"]
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_err = max(rel_err(x, y) for x, y in zip(k["grads"][nc:], p["grads"][nc:]))
    param_err, adam_err, moved, moved_tol, moved_g, n_sure, n_par = adam_checks(k, p)
    log(f"{label} (1024 rays, C {C}, K {K}, sigma noise {noise}, n_active_mean "
        f"{k['n_active']:.2f}): kernels {k['ms']:.2f} ms, plain {p['ms']:.2f} ms; launches "
        f"{k['launched']} (B1, B2) vs plain {p['launched']}; loss rel err {loss_err:.1e} "
        f"(tol 1e-5), worst fine gradient {grad_err:.1e} of max|grad| (tol 1e-3)"
        f"{dec.note()}, coarse "
        f"gradients zero: {k['coarse_zero'] and p['coarse_zero']}; post-Adam params "
        f"{param_err:.1e} apart on the {n_sure} of {n_par} sure entries (tol 1e-6), "
        f"{adam_err:.1e} from Adam's update of the two gradients (tol 1e-6), {moved} moved "
        f"(tol {moved_tol})")
    if not (k["launched"] == (1, 1) and p["launched"] == (0, 0) and loss_err <= 1e-5
            and grad_err <= 1e-3 and k["coarse_zero"] and p["coarse_zero"]
            and param_err <= 1e-6 and adam_err <= 1e-6 and moved <= moved_tol):
        raise AssertionError(f"{label}: the kernel step disagrees with the plain step")
    return {"kernel_ms": k["ms"], "plain_ms": p["ms"], "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "param_err": param_err, "adam_err": adam_err,
            "moved": moved, "n_active_mean": k["n_active"]}


class OccRecorder:
    """Watches an apps.train run under --train_occ: each occ step's launches
    and n_active_mean (read after the run), each refresh's launches, the
    occupied fraction at each window start, the phase switch (coarse and
    its Adam moments equal to fine right after the sync), and each render
    hook's grid and launches."""

    def __init__(self):
        self.steps, self.refreshes, self.windows, self.hooks, self.syncs = [], [], [], [], []
        self.hook_grids = set()

    def __enter__(self):
        import torch

        from nerf_shared_tpu_torch.apps import train as tapp
        from nerf_shared_tpu_torch.render.renderer import Renderer
        from nerf_shared_tpu_torch.train import occ_train

        rec = self
        self._stack = contextlib.ExitStack()

        def make_step(orig):
            def make(rcfg, *a, **kw):
                fn = orig(rcfg, *a, **kw)

                def step(state, *args, **kwargs):
                    before, s = launch_counts(), state.step
                    aux = fn(state, *args, **kwargs)
                    rec.steps.append((s, float(rcfg.raw_noise_std), diff(before),
                                      aux["n_active_mean"]))
                    return aux
                return step
            return make

        def update(orig):
            def fn(*a, **kw):
                before = launch_counts()
                out = orig(*a, **kw)
                rec.refreshes.append(diff(before))
                return out
            return fn

        def window(orig):
            def fn(self_, step):
                orig(self_, step)
                rec.windows.append((step, self_.warm, self_.occ.grid.float().mean()))
            return fn

        def hook_grid(orig):
            def fn(self_, step):
                grid = orig(self_, step)
                rec.hook_grids.add(id(grid))
                return grid
            return fn

        def sync(orig):
            def fn(state):
                out = orig(state)
                opt, fine = state.optimizer.state, state.fine.params()
                rec.syncs.append((state.step, all(
                    torch.equal(p, fine[k]) and all(torch.equal(opt[p][m], opt[fine[k]][m])
                                                    for m in ("exp_avg", "exp_avg_sq"))
                    for k, p in state.coarse.params().items())))
                return out
            return fn

        def render(orig):
            def fn(self_, *a, **kw):
                before = launch_counts()
                out = orig(self_, *a, **kw)
                g = kw.get("occ_grid")
                rec.hooks.append((g is not None and id(g) in rec.hook_grids, diff(before)))
                return out
            return fn

        for obj, name, make in ((occ_train, "make_occ_train_step", make_step),
                                (occ_train, "update_density_grid", update),
                                (tapp.OccTraining, "start_window", window),
                                (tapp.OccTraining, "hook_grid", hook_grid),
                                (tapp, "sync_coarse_from_fine", sync),
                                (Renderer, "render_from_batch_poses", render)):
            self._stack.enter_context(patched(obj, name, make))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def hook_launches(self):
        return {k: sum(d.get(k, 0) for _, d in self.hooks) for k in launch_counts()}


def diff(before):
    """launch_counts() now minus ``before``, zero entries dropped."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def train_rays_per_s(text):
    """Median [TRAIN] rays/s of a CLI log, the first window left out."""
    import re

    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text)]
    return statistics.median(rps[1:] if len(rps) > 1 else rps)


def phase_occ(device, trained, smi):
    """Phase 13: the occupancy-gated trainer at full lego width on phase 6's
    scene: (a) one refresh, one occ step, one budgeted step and one
    max_probes refresh through the kernels against the plain versions;
    (b) the two-phase run with resume from phase 6's checkpoint; (c) a run
    from scratch; (d) the vertex hashgrid under --train_occ."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.train.occ_train import (
        binarize_density_grid,
        init_density_grid,
        update_density_grid,
    )

    t_phase = time.perf_counter()
    setup = occ_setup(device, trained)
    a = setup["args"]
    G = a.train_occ_res
    n_cells = G ** 3
    per_refresh = math.ceil(n_cells / 65536)
    launches = {}

    # (a) a refresh, an occ step (the warm-up's sigma noise), a budgeted
    # step and a max_probes refresh, kernels against plain
    g = torch.Generator(device=device).manual_seed(17)
    jitter = torch.rand(n_cells, 3, generator=g, device=device) - 0.5
    state = occ_state(setup, device)
    dg0 = init_density_grid(*setup["aabb"], G, device)
    refresh = {}
    for fused in (True, False):
        rc = occ_rcfg(setup, fused, 0.0)

        def run(grid=dg0):
            return update_density_grid(grid, state.fine.params(), setup["cfg"], rc,
                                       decay=a.train_occ_decay, draws={"jitter": jitter})

        zero_counts()
        dg = run()
        torch.cuda.synchronize()
        refresh[fused] = (dg, launch_counts(), time_ms(run, 5))
    expect_launches("density refresh through the kernels", refresh[True][1],
                    {"fused_mlp_points": per_refresh})
    expect_launches("plain density refresh", refresh[False][1], {})
    refresh_err, refresh_flips, frac0 = occ_grid_check(
        f"density refresh {G}^3 ({n_cells} points, {per_refresh} B1 launches)",
        refresh[True][0], refresh[False][0], setup["alpha"])
    dg = refresh[True][0]
    occ = binarize_density_grid(dg, setup["alpha"])
    if not 0.0 < occ.occupied_fraction() < 1.0:
        raise AssertionError(f"the trained field's grid is {occ.occupied_fraction():.1%} "
                             "occupied")
    step_a = check_occ_step(setup, device, occ, None, float(a.train_occ_warmup_noise),
                            "occ step (warm-up noise)")
    step_b = check_occ_step(setup, device, occ, dg, 0.0, "budgeted occ step")
    m = n_cells // 4
    idx = torch.randint(0, n_cells, (m,), generator=g, device=device)
    jit2 = torch.rand(m, 3, generator=g, device=device) - 0.5
    probes = {}
    for fused in (True, False):
        zero_counts()
        probes[fused] = (update_density_grid(
            dg, state.fine.params(), setup["cfg"], occ_rcfg(setup, fused, 0.0),
            decay=a.train_occ_decay, max_probes=m, draws={"idx": idx, "jitter": jit2}),
            launch_counts())
    expect_launches("max_probes refresh through the kernels", probes[True][1],
                    {"fused_mlp_points": math.ceil(m / 65536)})
    probe_err, _, _ = occ_grid_check(f"max_probes refresh ({m} random cells)",
                                     probes[True][0], probes[False][0], setup["alpha"])
    del state

    # (b) the two-phase schedule with a resume, from phase 6's checkpoint
    logs = os.path.join(WORK, "occ_logs")
    expdir = os.path.join(logs, "lego_occ")
    os.makedirs(expdir)
    src = os.path.join(WORK, "train_logs", "lego_smoke")
    for f in ("000800.tar", "000800.ckpt.npz"):
        shutil.copy(os.path.join(src, f), expdir)
    warmup, until, end = 850, 1100, 1200
    argv = trained["base_argv"] + ["--basedir", logs, "--expname", "lego_occ"] + OCC_FLAGS + [
        "--train_occ_warmup", str(warmup), "--train_occ_until", str(until)]
    inner = tapp.dispatch_steps(config_parser().parse_args(argv + ["--N_iters", str(until)]))
    zero_counts()
    with OccRecorder() as rec:
        _, text = run_train_cli(argv + ["--N_iters", str(until)])
    occ_total = launch_counts()
    n_steps = until - 800
    bad = [s for s in rec.steps if s[2] != {"fused_mlp_points": 1, "fused_mlp_bwd": 1}]
    bad_r = [r for r in rec.refreshes if r != {"fused_mlp_points": per_refresh}]
    hooks = rec.hook_launches()
    want_total = {"fused_mlp_points": n_steps + per_refresh * len(rec.refreshes)
                  + hooks["fused_mlp_points"],
                  "fused_mlp_bwd": n_steps + hooks["fused_mlp_bwd"]}
    warm_active = [float(s[3]) for s in rec.steps if s[0] < warmup]
    after_warm = [float(f) for s, w, f in rec.windows if s >= warmup]
    log(f"occ-gated run 800 -> {until} ({inner} steps a dispatch): {len(rec.steps)} steps, "
        f"{len(rec.refreshes)} refreshes, launches {occ_total} (hooks {hooks}); warm-up "
        f"n_active_mean {min(warm_active):.2f}-{max(warm_active):.2f}; occupied after the "
        f"warm-up {min(after_warm):.1%}-{max(after_warm):.1%}; hook frames through the "
        f"training grid {[h[0] for h in rec.hooks]}")
    if (len(rec.steps) != n_steps or bad or bad_r or len(rec.refreshes) != n_steps // inner
            or any(occ_total.get(k, 0) != v for k, v in want_total.items())
            or set(warm_active) != {float(a.train_occ_keep)}
            or [s for s, w, _ in rec.windows if w] != list(range(800, warmup, inner))
            or not after_warm or not after_warm[0] < 1.0
            or not rec.hooks or not all(h[0] for h in rec.hooks) or "[PHASE]" in text):
        raise AssertionError(f"the occ-gated run: bad steps {bad[:3]}, bad refreshes "
                             f"{bad_r[:3]}, windows {[(s, w) for s, w, _ in rec.windows]}, "
                             f"hooks {rec.hooks}")
    occ_rps = train_rays_per_s(text)
    zero_counts()
    with OccRecorder() as rec2:
        state2, text2 = run_train_cli(argv + ["--N_iters", str(end)])
    hier_total = launch_counts()
    hooks2 = rec2.hook_launches()
    phase = [ln for ln in text2.splitlines() if ln.startswith("[PHASE]")]
    want_phase = [f"[PHASE] step {until}: occ -> hierarchical; coarse seeded from fine "
                  "(+Adam moments)"]
    hier_steps = end - until
    log(f"resumed {until} -> {end}: {phase}; sync check {rec2.syncs}; launches "
        f"{hier_total} (hooks {hooks2}); hook frames through a grid "
        f"{[h[0] for h in rec2.hooks]}")
    if (phase != want_phase or rec2.syncs != [(until, True)] or rec2.steps
            or hier_total["fused_mlp_points"] - hooks2["fused_mlp_points"] != 2 * hier_steps
            or hier_total["fused_mlp_bwd"] - hooks2["fused_mlp_bwd"] != 2 * hier_steps
            or any(h[0] for h in rec2.hooks) or state2.step != end):
        raise AssertionError("the switch to the hierarchical phase")
    hier_rps = train_rays_per_s(text2)
    ra = config_parser().parse_args(argv + ["--N_iters", str(end), "--render_only",
                                            "--render_test"])
    ds = load_datasets(ra)   # render_test: the render poses are the test views
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        _, rgbs = tapp.render_only(ra, return_rgbs=True, ds=ds)
    launches["occ_render_only"] = launch_counts()
    gts = ds.images[ds.i_test]
    held = float(np.mean([-10 * math.log10(float(np.mean((r - t) ** 2))) for r, t in
                          zip(rgbs, gts)]))
    white = float(np.mean([-10 * math.log10(float(np.mean((1.0 - t) ** 2))) for t in gts]))
    log(f"held-out PSNR after the two-phase run: {held:.2f} dB over {len(gts)} views "
        f"(all-white {white:.2f} dB)")
    if not held >= white + 2.0:
        raise AssertionError("held-out PSNR is not 2 dB above the all-white frame")
    launches["occ_two_phase"] = occ_total
    launches["occ_switch_resume"] = hier_total

    # (c) from scratch on phase 6's scene
    scene = os.path.join(WORK, "train_scene")
    lego = os.path.join(REPO, "configs", "lego.txt")
    scratch = ["--config", lego, "--datadir", scene, "--basedir",
               os.path.join(WORK, "occ_scratch_logs"), "--expname", "occ_scratch",
               "--device", device, "--testskip", "1", "--i_print", "10", "--i_testset", "0",
               "--i_video", "0", "--i_img", "0", "--i_weights", "300", "--N_iters", "300",
               "--train_occ_warmup", "100"] + OCC_FLAGS
    zero_counts()
    _, text3 = run_train_cli(scratch)
    launches["occ_scratch"] = launch_counts()
    lines = re.findall(r"\[TRAIN\] Iter: (\d+) Loss: (\S+)\s+PSNR: (\S+)", text3)
    losses = [float(x) for _, x, _ in lines]
    psnr = {int(i): float(p) for i, _, p in lines}
    log(f"occ-gated from scratch, 300 steps (warm-up 100): train PSNR step 10 "
        f"{psnr.get(10, float('nan')):.2f} -> step 300 {psnr.get(300, float('nan')):.2f} dB; "
        f"launches {launches['occ_scratch']}")
    if not (losses and all(math.isfinite(x) for x in losses) and psnr[300] > psnr[10]):
        raise AssertionError("the occ-gated run from scratch did not train")

    # (d) the vertex hashgrid at its defaults under --train_occ: the occ
    # step runs the fine pass only, one fused P1 forward and one P2
    # backward (the hierarchical step's 2 + 2 are two passes)
    vertex = ["--config", lego, "--datadir", scene, "--basedir",
              os.path.join(WORK, "occ_vertex_logs"), "--expname", "occ_vertex", "--device",
              device, "--testskip", "1", "--i_print", "10", "--i_testset", "0", "--i_video",
              "0", "--i_img", "0", "--i_weights", "0", "--model_type", "hashgrid",
              "--N_iters", "100"] + OCC_FLAGS
    zero_counts()
    with OccRecorder() as rec4:
        _, text4 = run_train_cli(vertex)
    launches["occ_vertex"] = launch_counts()
    kinds = {tuple(sorted(s[2].items())) for s in rec4.steps}
    log(f"vertex hashgrid under --train_occ, 100 steps: per-step launches {kinds}, "
        f"refreshes {len(rec4.refreshes)} ({rec4.refreshes[:1]} each); "
        f"{1e3 * 1024 / train_rays_per_s(text4):.2f} ms a step")
    if (len(rec4.steps) != 100
            or kinds != {(("gather", 1), ("scatter_add", 1))}):
        raise AssertionError(f"vertex hashgrid occ steps launched {kinds}")

    wall = time.perf_counter() - t_phase
    result = {
        "occ_step_ms": step_a["kernel_ms"], "occ_step_plain_ms": step_a["plain_ms"],
        "budget_step_ms": step_b["kernel_ms"], "budget_step_plain_ms": step_b["plain_ms"],
        "refresh_ms": refresh[True][2], "refresh_plain_ms": refresh[False][2],
        "refresh_err": refresh_err, "refresh_flips": refresh_flips, "probe_err": probe_err,
        "occupied_fraction": frac0, "trainer_occ_ms": 1e3 * a.N_rand / occ_rps,
        "trainer_occ_rays_per_s": occ_rps, "post_switch_ms": 1e3 * a.N_rand / hier_rps,
        "phase6_rays_per_s": trained["rays_per_s"], "held_out_psnr": held,
        "white_psnr": white, "scratch_psnr": [psnr[10], psnr[300]],
        "vertex_ms": 1e3 * 1024 / train_rays_per_s(text4), "steps": {
            "a": step_a, "b": step_b}, "launches_by_path": launches, "wall_s": wall}
    log(f"phase 13 occ: occ step {step_a['kernel_ms']:.2f} ms through B1 + B2 (plain "
        f"{step_a['plain_ms']:.2f}; budgeted {step_b['kernel_ms']:.2f}), refresh "
        f"{refresh[True][2]:.2f} ms ({per_refresh} B1; plain {refresh[False][2]:.2f}), "
        f"post-switch step {result['post_switch_ms']:.2f} ms; trainer occ-gated "
        f"{occ_rps:,.0f} rays/s = {result['trainer_occ_ms']:.2f} ms a step against phase 6's "
        f"{trained['rays_per_s']:,.0f} rays/s ({occ_rps / trained['rays_per_s']:.2f}x); "
        f"occupied {frac0:.1%} after one refresh of the 800-step field; held-out PSNR "
        f"{held:.2f} dB (white {white:.2f}); from scratch {psnr[10]:.2f} -> {psnr[300]:.2f} "
        f"dB; vertex hashgrid step {result['vertex_ms']:.2f} ms; {wall:.1f} s ({smi})")
    return result


def canon_faces(f):
    """A face set as sorted rows, each rolled to its smallest index."""
    import numpy as np

    roll = np.argmin(f, axis=1)
    rows = np.stack([f[np.arange(len(f)), (roll + k) % 3] for k in range(3)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def open_edges(verts, faces, lo, hi):
    """(edges not shared by exactly two faces inside the box, such edges
    on the box's faces): a marching-tetrahedra surface is closed except
    where it leaves the probed box."""
    import numpy as np

    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), 1)
    keys, counts = np.unique(e[:, 0].astype(np.int64) * len(verts) + e[:, 1],
                             return_counts=True)
    bad = keys[counts != 2]
    a, b = verts[bad // len(verts)], verts[bad % len(verts)]
    tol = 1e-5 * (np.asarray(hi) - np.asarray(lo))

    def on_face(v):
        return (np.abs(v - lo) <= tol) | (np.abs(v - hi) <= tol)

    boundary = (on_face(a) & on_face(b)).any(-1)
    return int((~boundary).sum()), int(boundary.sum())


def sigma_grad_norms(params, cfg, verts, device, block=65536):
    """|∇σ| at each vertex through the plain network (the normals' mask)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf

    dirs = torch.full((1, 3), 1.0 / math.sqrt(3.0), device=device)
    out = []
    for i in range(0, len(verts), block):
        with torch.enable_grad():
            p = torch.as_tensor(verts[i:i + block], device=device).requires_grad_(True)
            raw = apply_nerf(params, cfg, p[None], dirs)
            (gr,) = torch.autograd.grad(raw[0, :, 3].sum(), p)
        out.append(torch.linalg.norm(gr, dim=-1))
    return torch.cat(out).cpu().numpy()


def read_obj_counts(path):
    nv = nf = 0
    with open(path) as f:
        for line in f:
            nv += line.startswith("v ")
            nf += line.startswith("f ")
    return nv, nf


def mesh_iso(grid):
    """The export's iso level: the original NeRF export's 50 on raw sigma,
    or the probed grid's 99th percentile when the field never reaches 50."""
    import numpy as np

    return (50.0, "50") if float(grid.max()) > 50.0 else (
        float(np.percentile(grid, 99)), "the 99th percentile (the field stays below 50)")


def phase_mesh(device, trained, llff):
    """Phase 14: mesh export (apps/mesh_cli.py) of phase 6's checkpoint at
    --mesh_res 256 with colours and gradient normals, the native scan
    required; then phase 10's fern checkpoint at --mesh_res 128 with
    --mesh_world."""
    import dataclasses

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps import mesh_cli
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.ops import meshing as TM
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd
    from nerf_shared_tpu_torch.render import renderer as TR

    t_phase = time.perf_counter()
    R = 256
    argv = trained["base_argv"] + ["--N_iters", "800"]
    margs = mesh_cli.extend_parser_for_mesh(config_parser()).parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        eng = tapp.build_eval_engine(margs)
    params = {k: v.detach() for k, v in eng.fine.params().items()}
    cfg, rcfg = eng.fcfg, eng.renderer.cfg
    plain = dataclasses.replace(rcfg, use_pallas=False)
    lo, hi = mesh_cli.mesh_aabb(margs, eng.renderer, eng.ds, eng.H, eng.W)
    n_probe = math.ceil((R + 1) ** 3 / 65536)

    # the probe through B1 (timed) against the plain network on the 65^3
    # sub-lattice (every 4th point: the same coordinates)
    def probe():
        return TM.probe_density_grid(params, cfg, rcfg, lo, hi, resolution=R)

    zero_counts()
    grid = probe()
    expect_launches(f"probe {R + 1}^3", launch_counts(), {"fused_mlp_points": n_probe})
    probe_ms = time_ms(probe, 3)
    sub = TM.probe_density_grid(params, cfg, plain, lo, hi, resolution=R // 4)
    probe_err = float(np.abs(grid[::4, ::4, ::4] - sub).max()) / max(1.0, float(np.abs(sub).max()))
    iso, iso_src = mesh_iso(grid)
    spacing = (np.asarray(hi, np.float32) - np.asarray(lo, np.float32)) / np.float32(R)
    t0 = time.perf_counter()
    vn, fn = TM.marching_tetrahedra(grid, iso, lo, spacing, native="require")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vp, fp = TM.marching_tetrahedra(grid, iso, lo, spacing, native="never")
    numpy_s = time.perf_counter() - t0
    same = np.array_equal(vn, vp) and np.array_equal(canon_faces(fn), canon_faces(fp))
    inner_open, box_open = open_edges(vn, fn, lo, hi)
    log(f"probe {R + 1}^3 through B1 ({n_probe} launches): {probe_ms:.1f} ms, {probe_err:.1e} "
        f"of max(1, max|plain|) on the 65^3 sub-lattice (tol 2e-4); sigma max "
        f"{float(grid.max()):.1f}, iso {iso:.2f} ({iso_src}); scan native {native_s:.2f} s, "
        f"numpy {numpy_s:.2f} s, {len(vn)} vertices, {len(fn)} faces, bit-equal {same}; "
        f"edges not in exactly two faces: {inner_open} inside the box (tol 0), {box_open} "
        "on its faces (where the surface leaves the probed box)")
    if not (probe_err <= 2e-4 and same and len(fn) > 0 and inner_open == 0):
        raise AssertionError("the probe, the scans or the surface")

    # the CLI: native scan required, no plain network anywhere
    out = os.path.join(WORK, "mesh_lego.obj")
    plain_calls = []

    def count(orig):
        def fn_(*a, **kw):
            plain_calls.append(1)
            return orig(*a, **kw)
        return fn_

    zero_counts()
    t0 = time.perf_counter()
    with patched(TR, "apply_nerf", count), patched(fused_mlp_bwd, "apply_nerf", count), \
            patched(fused_mlp, "apply_nerf", count):
        (path, verts, faces), text = capture(lambda: mesh_cli.main(
            argv + ["--mesh_res", str(R), "--mesh_iso", repr(iso), "--mesh_color",
                    "--mesh_normals", "grad", "--mesh_out", out], native="require"))
    cli_s = time.perf_counter() - t0
    cli = launch_counts()
    nb = math.ceil(len(verts) / 65536)
    expect_launches("mesh CLI", cli, {"fused_mlp_points": n_probe + 2 * nb,
                                      "fused_mlp_bwd": nb})
    nv, nf = read_obj_counts(path)
    if (plain_calls or "cell scan: native" not in text or not np.array_equal(verts, vn)
            or not np.array_equal(faces, fn) or (nv, nf) != (len(vn), len(fn))):
        raise AssertionError(f"mesh CLI: plain calls {len(plain_calls)}, OBJ {nv} / {nf}")

    # colours and gradient normals against the plain route; the plain
    # normals on B2's ReLU decisions (ReluDecisions), block by block as
    # density_gradient_normals runs them: -grad sigma of masked_backward
    # with the cotangent of sigma alone
    dec = ReluDecisions()
    with dec.record():
        normals = TM.density_gradient_normals(params, cfg, rcfg, verts)
    normals_ms = time_ms(lambda: TM.density_gradient_normals(params, cfg, rcfg, verts), 3)
    blocks = [m for ms in dec.masks.values() for m in ms]
    dirs = TM._dummy_dirs(cfg, device)
    grads = []
    for i, masks in zip(range(0, len(verts), 65536), blocks):
        pt = torch.as_tensor(verts[i:i + 65536], device=device)[None]
        g = torch.zeros(pt.shape[:-1] + (fused_mlp.out_channels(cfg),), device=device)
        g[..., 3] = 1.0
        grads.append(masked_backward(params, cfg, pt, dirs, g, masks)[1][0])
    gr = torch.cat(grads)
    normals_p = (-gr / torch.clamp(torch.linalg.norm(gr, dim=-1, keepdim=True), min=1e-12)
                 ).cpu().numpy()
    colors = TM.vertex_colors(params, cfg, rcfg, verts, faces, normals=normals)
    colors_ms = time_ms(lambda: TM.vertex_colors(params, cfg, rcfg, verts, faces,
                                                 normals=normals), 3)
    colors_p = TM.vertex_colors(params, cfg, plain, verts, faces, normals=normals)
    mag = sigma_grad_norms(params, cfg, verts, device)
    strong = mag > 1e-3 * mag.max()
    n_err = float(np.abs(normals - normals_p)[strong].max())
    unit = float(np.abs(np.linalg.norm(normals, axis=1) - 1.0)[strong].max())
    c_err = float(np.abs(colors - colors_p).max())
    log(f"mesh CLI {cli_s:.1f} s: {path} with {nv} vertices, {nf} faces; launches {cli}; "
        f"colours {colors_ms:.1f} ms, in [{colors.min():.3f}, {colors.max():.3f}], {c_err:.1e} "
        f"from the plain route (tol 1e-4); gradient normals {normals_ms:.1f} ms (B1 + B2), "
        f"{n_err:.1e} from the plain route on {int(strong.sum())} of {len(verts)} vertices "
        f"with |grad sigma| > 1e-3 of its max (tol 1e-3){dec.note()}, unit to {unit:.1e}")
    if not (colors.min() >= 0.0 and colors.max() <= 1.0 and c_err <= 1e-4 and n_err <= 1e-3
            and unit <= 1e-5):
        raise AssertionError("mesh colours or gradient normals disagree with the plain route")
    launches = {"mesh_lego": cli}

    # the fern checkpoint at 128, NDC and world
    fargv = llff["argv"]
    feng = llff["engine"]
    fparams = {k: v.detach() for k, v in feng.fine.params().items()}
    fargs = mesh_cli.extend_parser_for_mesh(config_parser()).parse_args(fargv)
    flo, fhi = mesh_cli.mesh_aabb(fargs, feng.renderer, feng.ds, int(feng.ds.hwf[0]),
                                  int(feng.ds.hwf[1]))
    fgrid = TM.probe_density_grid(fparams, feng.fcfg, feng.renderer.cfg, flo, fhi, resolution=128)
    fiso, fiso_src = mesh_iso(fgrid)
    fl = fargv + ["--mesh_res", "128", "--mesh_iso", repr(fiso)]
    zero_counts()
    (_, nverts, nfaces), _ = capture(lambda: mesh_cli.main(
        fl + ["--mesh_out", os.path.join(WORK, "mesh_fern_ndc.obj")], native="require"))
    (_, wverts, wfaces), wtext = capture(lambda: mesh_cli.main(
        fl + ["--mesh_world", "--mesh_out", os.path.join(WORK, "mesh_fern_world.obj")],
        native="require"))
    launches["mesh_fern"] = launch_counts()
    log(f"fern at 128^3, iso {fiso:.2f} ({fiso_src}): {len(wverts)} world vertices, "
        f"z in [{wverts[:, 2].min() if len(wverts) else 0:.2f}, "
        f"{wverts[:, 2].max() if len(wverts) else 0:.2f}], faces flipped against the NDC "
        f"export: {np.array_equal(wfaces, nfaces[:, ::-1])}")
    if not (len(wfaces) > 0 and np.isfinite(wverts).all() and len(wverts) == len(nverts)
            and np.array_equal(wfaces, nfaces[:, ::-1])
            and "unwarped NDC mesh to world coordinates" in wtext):
        raise AssertionError("the fern world-space export")
    wall = time.perf_counter() - t_phase
    result = {"probe_ms": probe_ms, "probe_err": probe_err, "iso": iso, "native_scan_s":
              native_s, "numpy_scan_s": numpy_s, "vertices": len(verts), "faces": len(faces),
              "colors_ms": colors_ms, "colors_err": c_err, "normals_ms": normals_ms,
              "normals_err": n_err, "cli_s": cli_s, "fern_iso": fiso,
              "open_edges_on_box": box_open,
              "fern_faces": len(wfaces), "launches_by_path": launches, "wall_s": wall}
    log(f"phase 14 mesh: probe {probe_ms:.1f} ms ({R + 1}^3, {n_probe} B1), scan native "
        f"{native_s:.2f} s / numpy {numpy_s:.2f} s, {len(verts)} vertices, {len(faces)} "
        f"faces (iso {iso:.2f}), colours {colors_ms:.1f} ms, gradient normals "
        f"{normals_ms:.1f} ms; fern 128^3 {len(wfaces)} faces; {wall:.1f} s")
    return result


# ---- phase 15: --precision bf16 -------------------------------------------

# the bf16 tensor cores' dense peak (NVIDIA H100 SXM data sheet): the
# bound of the bf16 instantiations, whose products take bf16 operands
PEAK_BF16_FLOPS = 989e12
# a bf16 kernel against its plain bf16 version (the same roundings, fp32
# sums in another order, which flip a bf16 rounding now and then: a few
# bf16 ulps), of max(1, max|plain|); B2 of each gradient's max
BF16_TOL = 1e-2
# bf16 against fp32, the JAX tests' bars: raw within rtol / atol 0.1
# (tests/test_pallas.py test_fused_bf16_close_to_fp32); each gradient's norm
# within 2% of fp32's and their cosine above 0.999
# (tests/test_pallas_bwd.py test_bf16_compute_grads_close, at its D4/W64).
# The JAX package's own bf16 backward meets that cosine only at some
# weights: on the CPU its test's shapes give 0.99916 at PRNGKey(2) (the
# test's) and 0.99809 at PRNGKey(1), and the lego width 0.994 on seeded
# inputs (a bf16 forward flips ReLU masks near zero, layer after layer).
# So a bf16 gradient is held against fp32 as closely as the plain bf16
# version (the JAX kernel's arithmetic) comes on the same weights: its
# cosine within BF16_COS_SLACK of the plain version's, its norm's
# deviation within BF16_NORM_SLACK of the plain one's; the JAX bars'
# numbers are logged beside it
BF16_RAW_TOL, BF16_NORM_TOL, BF16_COS = 0.1, 2e-2, 0.999
BF16_COS_SLACK, BF16_NORM_SLACK = 1e-3, 5e-3
# B4 is held where its composites are not empty: on phase 6's weights at
# least BF16_B4_OPAQUE of the rays held reach acc > 0.5; at the other
# architectures' seeded weights sigma's bias is raised by BF16_B4_SIGMA
BF16_B4_OPAQUE, BF16_B4_SIGMA = 0.2, 3.0
BF16_TC_DESIGN = ("bf16 operands on wgmma.m64nNk16 with A read from shared memory (the "
                  "activations and the encoded inputs, formed once a tile, in bf16 operand "
                  "blocks), fp32 accumulators; 128-point tiles, each consumer warpgroup "
                  "its own 64-point pipeline over all the GEMM's columns; a producer warp "
                  "streaming 64-row weight stages by bulk copies through an mbarrier "
                  "ring, one stage of MMAs in flight; h / feature / hv rounded to bf16 "
                  "in the epilogue (csrc/mlp_tile_bf16.cuh)")
# the bf16 forward kernels' names in SASS and ptxas's log (phase 15 logs
# their registers and spills)
BF16_FORWARD = {"fused_mlp": ("nerf_points_bf16_kernel", "nerf_rays_bf16_kernel"),
                "fused_render": ("nerf_render_bf16_kernel",)}
BF16_B2_DESIGN = ("tile kernel: B1's bf16 tile, forward remat + input gradients "
                  "dh = dz_c·W with one wgmma.m64nNk16 bf16 product a 16-row slice, each "
                  "dz written in fp32 and rounded as it is stored for the next product; "
                  "nerf_dw_bf16_kernel: dW with one mma.sync.m16n8k16 bf16 product a "
                  "16-point step, dZ rounded as it is loaded, bias sums of the fp32 dZ "
                  "(csrc/fused_mlp_bwd.cu)")


def bf16_bound(cfg, params, n_points, io_bytes, flops=None):
    """(bound_ms, bound_by) of a bf16 instantiation: its FLOPs (the
    network's, or ``flops``) over the bf16 peak vs ``io_bytes`` plus the
    bf16 weights over the memory rate."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    flops = flops_per_point(cfg) * n_points if flops is None else flops
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = (io_bytes + network_bytes(params, cfg) // 2) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def raw_close(got, want, tol=BF16_RAW_TOL):
    """(max |got - want| - tol |want|, whether |got - want| <= tol + tol
    |want| everywhere: numpy's allclose with rtol = atol = tol)."""
    excess = float(((got - want).abs() - tol * want.abs()).max())
    return excess, excess <= tol


def grads_close(got, want):
    """{name: (norm ratio - 1, cosine)} of two gradient sets and whether
    every norm is within BF16_NORM_TOL and every cosine above BF16_COS (the
    JAX tests' bars)."""
    out = {}
    for k, w in want.items():
        a, b = got[k].double().reshape(-1), w.double().reshape(-1)
        na, nb = float(a.norm()), float(b.norm())
        cos = float(a @ b) / max(1e-300, na * nb)
        out[k] = (na / nb - 1.0 if nb > 0 else 0.0, cos if nb > 0 else 1.0)
    ok = all(abs(r) <= BF16_NORM_TOL and c > BF16_COS for r, c in out.values())
    return out, ok


def grads_as_close(got, plain, ref):
    """{name: (norm ratio - 1, cosine) of ``got`` and of ``plain`` against
    ``ref``} and whether ``got`` is as close to ``ref`` as ``plain`` is:
    every cosine within BF16_COS_SLACK of plain's, every norm deviation
    within BF16_NORM_SLACK of plain's."""
    g, _ = grads_close(got, ref)
    p, _ = grads_close(plain, ref)
    ok = all(g[k][1] >= p[k][1] - BF16_COS_SLACK
             and abs(g[k][0]) <= abs(p[k][0]) + BF16_NORM_SLACK for k in g)
    return {k: (g[k], p[k]) for k in g}, ok


def bf16_jax_test_bars(device):
    """bf16 against fp32 through the port's kernels at the JAX tests' own
    shapes: tests/test_pallas.py test_fused_bf16_close_to_fp32 (B1, D2/W128,
    multires 4/2, skip at 0, 4 x 6 points: raw within rtol = atol = 0.1)
    and tests/test_pallas_bwd.py test_bf16_compute_grads_close (B1 + B2
    under autograd, D4/W64, multires 6/3, skip at 1, 6 x 8 points, the loss
    mean(tanh(raw)^2)): the gradients held by grads_as_close against the
    plain bf16 version's on the same weights, the JAX bars' norm and cosine
    logged. Weights from the torch init (no JAX here), points from the
    tests' numpy seeds."""
    import numpy as np
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, torch_param_order
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    def points(n_rays, n_samples, seed):
        rng = np.random.default_rng(seed)
        pts = rng.standard_normal((n_rays, n_samples, 3)).astype(np.float32)
        dirs = rng.standard_normal((n_rays, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, -1, keepdims=True)
        return torch.from_numpy(pts).to(device), torch.from_numpy(dirs).to(device)

    cfg = NeRFConfig(D=2, W=128, multires=4, multires_views=2, skips=(0,))
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=device, generator=torch.Generator().manual_seed(0)).params().items()}
    pts, dirs = points(4, 6, 0)
    with torch.no_grad():
        fwd = raw_close(fused_mlp.fused_nerf_forward(params, cfg, pts, dirs, torch.bfloat16),
                        fused_mlp.fused_nerf_forward(params, cfg, pts, dirs))
    cfg = NeRFConfig(D=4, W=64, multires=6, multires_views=3, skips=(1,))
    names = torch_param_order(cfg)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=device, generator=torch.Generator().manual_seed(2)).params().items()}
    pts, dirs = points(6, 8, 2)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        w = {k: params[k].clone().requires_grad_(True) for k in names}
        loss = torch.tanh(fused_mlp.fused_nerf_forward(w, cfg, pts, dirs, dtype)).pow(2).mean()
        grads[dtype] = dict(zip(names, torch.autograd.grad(loss, [w[k] for k in names])))
    raw = fused_mlp.plain_nerf_forward(params, cfg, pts, dirs, torch.bfloat16)
    t = torch.tanh(raw)
    g = 2 * t * (1 - t * t) / raw.numel()   # d mean(tanh(raw)^2) / d raw
    plain = fused_mlp_bwd.plain_mlp_backward_bf16(params, cfg, pts, dirs, g)[0]
    both, ok = grads_as_close(grads[torch.bfloat16], plain, grads[torch.float32])
    bar, bar_ok = grads_close(grads[torch.bfloat16], grads[torch.float32])
    worst_norm = max(abs(r) for r, _ in bar.values())
    worst_cos = min(c for _, c in bar.values())
    plain_cos = min(pc for _, (_, pc) in both.values())
    log(f"  bf16 vs fp32 at the JAX tests' shapes: B1 D2/W128 raw "
        f"max |bf16 - fp32| - 0.1 |fp32| = {fwd[0]:.3e} (allclose at 0.1); B1 + B2 "
        f"D4/W64 gradients of mean(tanh(raw)^2): norms within {100 * worst_norm:.3f}% "
        f"(JAX bar {100 * BF16_NORM_TOL:g}%), lowest cosine {worst_cos:.6f} (JAX bar > "
        f"{BF16_COS}; met: {bar_ok}), the plain bf16 version's {plain_cos:.6f}; held "
        f"within {BF16_COS_SLACK:g} / {BF16_NORM_SLACK:g} of the plain version's")
    if not (fwd[1] and ok):
        raise AssertionError("bf16 against fp32 at the JAX tests' shapes: raw outside "
                             "0.1, or the gradients further from fp32 than the plain bf16 "
                             "version's")
    return {"fwd_excess": fwd[0], "worst_norm": worst_norm, "worst_cos": worst_cos,
            "plain_worst_cos": plain_cos, "jax_bars_met": bar_ok}


def ptxas_report(lib, kernel):
    """(registers, spill store bytes, spill load bytes, warnings) that
    ptxas reported for ``kernel`` in ``lib``'s build log (phase 1's
    build), or None when the log does not hold it. Warnings include its
    C75xx notes on wgmma (an injected warpgroup.arrive, serialised
    MMAs)."""
    import re

    from nerf_shared_tpu_torch.ops.cuda import common

    current, got, warnings = None, {}, []
    for line in common.BUILD_LOG.get(lib, "").splitlines():
        if "Compiling entry function" in line and "'" in line:
            current = demangled(line.split("'")[1])
        elif ("warning" in line or "(C75" in line) and kernel in demangled_names(line):
            note = re.sub(r"line \d+", "line N",
                          re.split(r" in (?:the )?function", line)[0].strip())
            if note not in warnings:
                warnings.append(note)
        elif current and current.endswith(kernel):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                got["spill"] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                got["regs"] = int(m.group(1))
    if "regs" not in got:
        return None
    return got["regs"], *got.get("spill", (0, 0)), warnings


def demangled_names(line):
    """The demangled names of the symbols a log line quotes."""
    return " ".join(demangled(w.strip("'\",.()")) for w in line.split() if "_Z" in w)


def bf16_case(kernel, label, n_points, S, err, t, tp, t32, bnd, design, tiles=None,
              **extra):
    """Log and record one bf16 kernel's case: t / tp its and its plain bf16
    version's (median, min, max) ms in turns, t32 the fp32 kernel's in
    turns with it, bnd its bf16 bound; ``tiles``: a forward kernel's
    128-point tiles, for its us a tile (an SM's share of them in a row)."""
    bms, by = bnd
    per_tile = ""
    if tiles:
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        extra["us_per_tile"] = 1e3 * t[0] * min(sms, tiles) / tiles
        per_tile = f"; {extra['us_per_tile']:.2f} us a tile ({tiles} tiles on {sms} SMs)"
    log(f"{label} bf16: max err {err:.3e} vs its plain bf16 version (tol {BF16_TOL:g}); "
        f"{spread(t)} ms vs plain bf16 {spread(tp)} ms (median [min-max] in turns); "
        f"fp32 kernel {spread(t32)} ms in turns with it ({t32[0] / t[0]:.2f}x); "
        f"bound {bms:.3f} ms bf16 ({by}), {100 * bms / t[0]:.1f}% of it{per_tile}")
    return dict(kernel=kernel, S=S, n_points=n_points, max_abs_err=err, ms=t[0],
                ms_min=t[1], ms_max=t[2], plain_ms=tp[0], plain_min=tp[1],
                plain_max=tp[2], fp32_ms=t32[0], fp32_min=t32[1], fp32_max=t32[2],
                bound_ms=bms, bound_by=by, design=design, **extra)


def bf16_other_shapes(device):
    """The bf16 B1, B3 and B4 against their plain bf16 versions (BF16_TOL)
    on phase 2's other architectures at S = 7 and 65 (37 rays; tiles that
    end mid-ray, 16-row slices padding K), and B2 at 37 x 7 and 300 x 65
    points as close to fp32 as its plain bf16 version (grads_as_close: at
    a few hundred points a ReLU mask or a dz rounding that flips with the
    sum order moves a deep network's gradient by percents)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd, fused_render

    bf = torch.bfloat16
    archs = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
             dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
             dict(D=2, W=30, skips=(0,), i_embed=-1),
             dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
    worst = {"B1": 0.0, "B3": 0.0, "B4": 0.0}
    n_b4 = n_opaque = 0
    for i, kw in enumerate(archs):
        cfg = NeRFConfig(**kw)
        params = {k: v.detach() for k, v in NeRF(
            cfg, device=device, generator=torch.Generator().manual_seed(i)).params().items()}
        for S in (7, 65):
            o, d, z, vd = rays_at(37, S, seed=i, device=device)
            vd = vd if cfg.use_viewdirs else None
            pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
            with torch.no_grad():
                pairs = {
                    "B1": (fused_mlp.fused_nerf_forward(params, cfg, pts, vd, bf),
                           fused_mlp.plain_nerf_forward(params, cfg, pts, vd, bf)),
                    "B3": (fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd, bf),
                           fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd, bf))}
                if cfg.use_viewdirs or cfg.output_ch >= 4:
                    # B4 with the density raised: at seeded weights sigma <= 0
                    # on most samples and every composite would be empty
                    dense = with_density(params, cfg, BF16_B4_SIGMA)
                    raw = fused_mlp.plain_nerf_forward_rays(dense, cfg, o, d, z, vd, bf)
                    mask = raw[:, -1, 3].abs() >= 1e-2
                    got = fused_render.fused_render_rays(dense, cfg, o, d, z, vd, True, True, bf)
                    want = fused_render.plain_render_rays(dense, cfg, o, d, z, vd, True, bf)
                    e4 = max(float((g[mask] - w[mask]).abs().max())
                             / max(1.0, float(w[mask].abs().max()))
                             for g, w in zip(got, want))
                    worst["B4"] = max(worst["B4"], e4)
                    n_b4 += int(mask.sum())
                    n_opaque += int((want[2][mask] > 0.5).sum())
            for k, (g, w) in pairs.items():
                worst[k] = max(worst[k], float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
        for n_rays, S in ((37, 7), (300, 65)):
            pts, vd, g = lego_points(n_rays, S, seed=10 + i, device=device)
            vd = vd if cfg.use_viewdirs else None
            g = g[..., :fused_mlp.out_channels(cfg)].contiguous() if cfg.use_viewdirs \
                else torch.cat([g, g[..., :1]], -1).contiguous()
            got = fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g, bf)
            plain = fused_mlp_bwd.plain_mlp_backward_bf16(params, cfg, pts, vd, g)
            f32 = fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g)

            def named(out):
                return {**out[0], "dpts": out[1], **({"ddirs": out[2]} if vd is not None else {})}

            both, ok = grads_as_close(named(got), named(plain), named(f32))
            if not ok:
                raise AssertionError(f"B2 bf16 at {kw} N={n_rays * S} is further from fp32 "
                                     f"than its plain bf16 version: {both}")
    log(f"  bf16 at phase 2's other architectures (S = 7, 65): worst B1 {worst['B1']:.1e}, "
        f"B3 {worst['B3']:.1e}, B4 {worst['B4']:.1e} of max(1, max|plain|) (tol "
        f"{BF16_TOL:g}; B4 with sigma's bias raised by {BF16_B4_SIGMA:g}: {n_opaque} of "
        f"{n_b4} rays held with acc > 0.5, at least half required); B2 at 259 and 19,500 "
        f"points as close to fp32 as its plain version")
    if max(worst.values()) > BF16_TOL:
        raise AssertionError(f"bf16 kernels disagree at the other architectures: {worst}")
    if not 2 * n_opaque >= n_b4 > 0:
        raise AssertionError(f"bf16 B4 at the other architectures: {n_opaque} of {n_b4} "
                             "rays held have acc > 0.5")
    return worst


def with_density(params, cfg, shift):
    """``params`` with sigma's output bias raised by ``shift``."""
    name = "alpha_linear.bias" if cfg.use_viewdirs else "output_linear.bias"
    bias = params[name].clone()
    bias[0 if cfg.use_viewdirs else 3] += shift
    return {**params, name: bias}


def trained_fine_params(trained, cfg, device):
    """Phase 6's fine network (its last .tar) as a parameter dict."""
    from nerf_shared_tpu_torch.models.nerf import NeRF
    from nerf_shared_tpu_torch.utils.checkpoints import load_tar

    _, fine_sd, _ = load_tar(trained["fine_ckpt"])
    net = NeRF(cfg, device=device)
    net.load_state_dict(fine_sd, strict=True)
    return {k: v.detach() for k, v in net.params().items()}


def bf16_kernel_cases(device, trained):
    """Phase 15 (a) and (b): each bf16 instantiation against its plain bf16
    version and against the fp32 kernel, on the same inputs at the fp32
    phases' shapes, timed in turns with both: B1, B2 and B3 on seeded
    weights, B4 on phase 6's trained fine network (seeded weights put no
    density on these rays, so every composite would be empty)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd, fused_render
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import flops_per_point_bwd

    bf = torch.bfloat16
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=device, generator=torch.Generator().manual_seed(15)).params().items()}
    cases, vs32 = [], {}
    for lib, names in BF16_FORWARD.items():
        for name in names:
            rep = ptxas_report(lib, name)
            if rep is None:
                log(f"  ptxas {lib} {name}: not in this run's build log")
                continue
            log(f"  ptxas {lib} {name}: {rep[0]} registers, {rep[1]} bytes spill stores, "
                f"{rep[2]} bytes spill loads; warnings: {rep[3] or 'none'}")

    def check(label, err, scale, ok_extra=True):
        if not (err <= BF16_TOL * max(1.0, scale) and ok_extra):
            raise AssertionError(f"{label} bf16 disagrees with its plain bf16 version "
                                 f"(max err {err:.3e}, tol {BF16_TOL:g} x {max(1.0, scale):.3g})")

    with torch.no_grad():
        # B1 at a lego step's coarse and fine shapes
        for S in (64, 192):
            pts, vd, _ = lego_points(1024, S, seed=S, device=device)
            n = 1024 * S
            got = fused_mlp.fused_nerf_forward(params, cfg, pts, vd, bf)
            want = fused_mlp.plain_nerf_forward(params, cfg, pts, vd, bf)
            f32 = fused_mlp.fused_nerf_forward(params, cfg, pts, vd)
            err = float((got - want).abs().max())
            check(f"B1 N={n}", err, float(want.abs().max()))
            vs32[f"B1 N={n}"] = raw_close(got, f32)
            t, tp = in_turns(lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd, bf),
                             lambda: fused_mlp.plain_nerf_forward(params, cfg, pts, vd, bf),
                             reps=10)
            t32, _ = in_turns(lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                              lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd, bf),
                              rounds=2, reps=10)
            cases.append(bf16_case(
                "fused_mlp_points_bf16", f"B1 fused_mlp points N={n}", n, S, err, t, tp,
                t32, bf16_bound(cfg, params, n, 4 * (1024 * 3 + n * 3 + n * 4)),
                BF16_TC_DESIGN + "; point-major encoder (f·x)", tiles=-(-n // 128)))
        # B3 at a 32768-ray block of the coarse and fine passes, B4 at the fine
        for S in (64, 192):
            o, d, z, vd = lego_rays(32768, S, seed=S, device=device)
            n = 32768 * S
            got = fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd, bf)
            want = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd, bf)
            f32 = fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd)
            err = float((got - want).abs().max())
            check(f"B3 S={S}", err, float(want.abs().max()))
            vs32[f"B3 S={S}"] = raw_close(got, f32)
            del got, want, f32
            # 6 samples of 2 calls each: the plain version takes ~0.3 s a call
            t, tp = in_turns(
                lambda: fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd, bf),
                lambda: fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd, bf),
                rounds=3, reps=2)
            t32, _ = in_turns(
                lambda: fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd),
                lambda: fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd, bf),
                rounds=2, reps=2)
            cases.append(bf16_case(
                "fused_mlp_bf16", f"B3 fused_mlp S={S}", n, S, err, t, tp, t32,
                bf16_bound(cfg, params, n, 4 * (32768 * 9 + n + n * 4)), BF16_TC_DESIGN,
                tiles=-(-n // 128), n_rays=32768))
        tp_ = trained_fine_params(trained, cfg, device)
        o, d, z, vd = lego_rays(32768, 192, seed=7, device=device)
        n = 32768 * 192
        got = fused_render.fused_render_rays(tp_, cfg, o, d, z, vd, True, True, bf)
        want = fused_render.plain_render_rays(tp_, cfg, o, d, z, vd, True, bf)
        f32 = fused_render.fused_render_rays(tp_, cfg, o, d, z, vd, True, True)
        raw = fused_mlp.plain_nerf_forward_rays(tp_, cfg, o, d, z, vd, bf)
        mask = raw[:, -1, 3].abs() >= 1e-2  # clear of the 1e10 sentinel flip
        del raw
        # each output (rgb, disp, acc, weights, depth) on the masked rays
        errs = [float((g[mask] - w[mask]).abs().max()) for g, w in zip(got, want)]
        for i, w in enumerate(want):
            check(f"B4 S=192 output {i}", errs[i], float(w[mask].abs().max()))
        opaque = [float((x[2][mask] > 0.5).float().mean()) for x in (got, want)]
        log(f"  B4 bf16 S=192 on phase 6's weights: {int(mask.sum())} of {z.shape[0]} rays "
            f"clear of the sentinel, acc > 0.5 on {100 * opaque[0]:.1f}% of them (the plain "
            f"version {100 * opaque[1]:.1f}%; at least {100 * BF16_B4_OPAQUE:g}% required)")
        if int(mask.sum()) < z.shape[0] // 20:
            raise AssertionError(f"B4 bf16: {int(mask.sum())} rays clear of the sentinel")
        if min(opaque) < BF16_B4_OPAQUE:
            raise AssertionError(f"B4 bf16: acc > 0.5 on {opaque} of the rays held")
        err = max(errs)
        vs32["B4 S=192 rgb"] = raw_close(got[0][mask], f32[0][mask])
        vs32["B4 S=192 acc"] = raw_close(got[2][mask], f32[2][mask])
        del got, want, f32
        t, tp = in_turns(
            lambda: fused_render.fused_render_rays(tp_, cfg, o, d, z, vd, True, False, bf),
            lambda: fused_render.plain_render_rays(tp_, cfg, o, d, z, vd, True, bf),
            rounds=3, reps=2)
        t32, _ = in_turns(
            lambda: fused_render.fused_render_rays(tp_, cfg, o, d, z, vd, True, False),
            lambda: fused_render.fused_render_rays(tp_, cfg, o, d, z, vd, True, False, bf),
            rounds=2, reps=2)
        cases.append(bf16_case(
            "fused_render_bf16", "B4 fused_render S=192", n, 192, err, t, tp, t32,
            bf16_bound(cfg, params, n, 4 * (32768 * 12 + n + 32768 * 8)), BF16_TC_DESIGN
            + "; the composite in fp32", tiles=-(-n // 128), n_rays=32768,
            masked_rays=int(mask.sum())))
    # B2 on a seeded cotangent at both lego shapes
    for S in (64, 192):
        pts, vd, g = lego_points(1024, S, seed=S, device=device)
        n = 1024 * S
        *got, hbuf, n_pad = fused_mlp_bwd.launch_backward_h(params, cfg, pts, vd, g, bf)
        masks = relu_masks(cfg, hbuf, n_pad, n)
        del hbuf
        switches, z_worst = relu_switches(cfg, params, pts, vd, masks, bf16=True)
        own = fused_mlp_bwd.plain_mlp_backward_bf16(params, cfg, pts, vd, g)
        want = masked_backward_bf16(params, cfg, pts, vd, g, masks)
        f32 = fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g)
        torch.cuda.synchronize()
        names = list(want[0]) + ["dpts", "ddirs"]
        trip = [(got[0][k], want[0][k], f32[0][k]) for k in want[0]] + [
            (got[1], want[1], f32[1]), (got[2], want[2], f32[2])]
        rel = {k: rel_err(a, b) for k, (a, b, _) in zip(names, trip)}
        worst = max(rel, key=rel.get)
        err = max(float((a - b).abs().max()) for a, b, _ in trip)
        own_rel = max(rel_err(a, b) for a, b in zip(
            [got[0][k] for k in own[0]] + [got[1], got[2]],
            list(own[0].values()) + [own[1], own[2]]))
        del own
        log(f"  B2 bf16 N={n}: on its ReLU decisions worst {worst} {rel[worst]:.1e} of its "
            f"max|grad| vs the plain bf16 version (tol {BF16_TOL:g}) over {len(rel)} tensors; "
            f"{switches} decisions other than the plain bf16 forward's, all at "
            f"|pre-activation| <= {z_worst:.1e} of the layer's max (tol {RELU_SWITCH_BF16:g}); "
            f"vs the plain bf16 version on its own decisions worst {own_rel:.1e}")
        if not (rel[worst] <= BF16_TOL and z_worst <= RELU_SWITCH_BF16):
            raise AssertionError(f"B2 bf16 disagrees with its plain bf16 version: {rel}, "
                                 f"ReLU decisions switched up to {z_worst:.1e}")
        vs32[f"B2 N={n}"] = grads_as_close({k: a for k, (a, _, _) in zip(names, trip)},
                                           {k: b for k, (_, b, _) in zip(names, trip)},
                                           {k: c for k, (_, _, c) in zip(names, trip)})
        del got, want, f32, trip
        t, tp = in_turns(
            lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g, bf),
            lambda: fused_mlp_bwd.plain_mlp_backward_bf16(params, cfg, pts, vd, g), reps=5)
        t32, _ = in_turns(
            lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g),
            lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g, bf),
            rounds=2, reps=5)
        parts = kernels_ms(
            lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g, bf), 3,
            ("nerf_bwd_bf16_kernel", "nerf_dw_bf16_kernel", "grad_reduce_kernel"))
        total, dw = flops_per_point_bwd(cfg) * n, flops_per_point(cfg) * n
        io = 4 * (n * 3 + 1024 * 3 + n * 4 + n * 6) + 2 * 4 * sum(
            params[k].numel() for k in params)
        bnd = bf16_bound(cfg, params, n, io, flops=total)
        cuda_cores = 1e3 * max((total - dw) / PEAK_FP32_FLOPS + dw / PEAK_BF16_FLOPS,
                               io / PEAK_BYTES)
        log(f"  B2 bf16 N={n} device ms by kernel (profiler, 3 calls): tile "
            f"{parts['nerf_bwd_bf16_kernel']}, dW {parts['nerf_dw_bf16_kernel']}, reduce "
            f"{parts['grad_reduce_kernel']}; bound {bnd[0]:.3f} ms (all FLOPs bf16), "
            f"{cuda_cores:.2f} ms with the tile's FLOPs on the fp32 CUDA cores")
        cases.append(bf16_case(
            "fused_mlp_bwd_bf16", f"B2 fused_mlp_bwd N={n}", n, S, err, t, tp, t32, bnd,
            BF16_B2_DESIGN, max_rel_err=rel[worst], bound_tile_cuda_cores_ms=cuda_cores,
            tile_ms=parts["nerf_bwd_bf16_kernel"], dw_ms=parts["nerf_dw_bf16_kernel"],
            reduce_ms=parts["grad_reduce_kernel"]))
    bad, summary = [], {}
    for label, v in vs32.items():
        if isinstance(v[0], dict):
            kern = {k: g for k, (g, _) in v[0].items()}
            plain = {k: p for k, (_, p) in v[0].items()}
            summary[label] = {
                "kernel": {"worst_norm": max(abs(r) for r, _ in kern.values()),
                           "worst_cos": min(c for _, c in kern.values())},
                "plain_bf16": {"worst_norm": max(abs(r) for r, _ in plain.values()),
                               "worst_cos": min(c for _, c in plain.values())}}
            k_, p_ = summary[label]["kernel"], summary[label]["plain_bf16"]
            log(f"  bf16 vs fp32 {label}: gradient norms within "
                f"{100 * k_['worst_norm']:.3f}% (the plain bf16 version "
                f"{100 * p_['worst_norm']:.3f}%), lowest cosine {k_['worst_cos']:.6f} "
                f"(plain bf16 {p_['worst_cos']:.6f}); each tensor within "
                f"{BF16_COS_SLACK:g} of the plain version's cosine and "
                f"{BF16_NORM_SLACK:g} of its norm deviation")
        else:
            summary[label] = v[0]
            log(f"  bf16 vs fp32 {label}: max |bf16 - fp32| - 0.1 |fp32| = {v[0]:.3e} "
                f"(allclose at rtol = atol = {BF16_RAW_TOL})")
        if not v[1]:
            bad.append(label)
    if bad:
        raise AssertionError(f"bf16 against fp32 outside its bars: {bad}")
    summary["jax_test_shapes"] = bf16_jax_test_bars(device)
    summary["other_shapes"] = bf16_other_shapes(device)
    return cases, summary


@contextlib.contextmanager
def bf16_plain_versions(decisions=None):
    """Inside the block fused_train_op's bf16 route on CUDA tensors runs the
    plain versions of bf16 B1 and B2 (fused_mlp.plain_nerf_forward,
    fused_mlp_bwd.plain_mlp_backward_bf16) where it launches the kernels:
    the plain bf16 step, for holding the kernel step against; B2's plain
    version on the ReLU decisions ``decisions`` recorded (ReluDecisions,
    masked_backward_bf16)."""
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    import torch

    def forward(orig):
        def run(params, cfg, pts, viewdirs, compute_dtype=torch.float32, hout=None):
            if compute_dtype != torch.bfloat16:
                return orig(params, cfg, pts, viewdirs, compute_dtype, hout)
            return fused_mlp.plain_nerf_forward(params, cfg, pts, viewdirs, compute_dtype)
        return run

    def backward(orig):
        def run(params, cfg, pts, viewdirs, g, compute_dtype=torch.float32, saved=None,
                dx=True):
            if compute_dtype != torch.bfloat16:
                return orig(params, cfg, pts, viewdirs, g, compute_dtype, saved, dx)
            key = (pts.numel() // 3, cfg)
            if decisions is None or key not in decisions.masks:
                return fused_mlp_bwd.plain_mlp_backward_bf16(params, cfg, pts, viewdirs, g)
            return masked_backward_bf16(params, cfg, pts, viewdirs, g, decisions.masks[key][0])
        return run

    with patched(fused_mlp_bwd, "launch_points", forward), \
            patched(fused_mlp_bwd, "launch_backward", backward):
        yield


def check_bf16_train_step(device):
    """Phase 15 (d): one lego training step under --precision bf16 from one
    state with the draws pinned as phase 5 pins them, through the bf16 B1
    + B2 and through their plain versions (bf16_plain_versions): the loss
    within 1e-3 and every field gradient within BF16_TOL of its max (the
    same roundings; fp32 sums in another order flip one now and then, and
    the fine samples follow the coarse weights). Beside it, for the record,
    the plain network's bf16 step (apply_nerf in bf16 and autograd, which
    rounds in other places) and the fp32 kernel step: each one's gradient
    norms and cosines against the fp32 step's. Times all four."""
    import torch

    out = {}
    dec = ReluDecisions()
    for label, fused, precision in (("kernels", True, "bf16"), ("plain", True, "bf16"),
                                    ("network", False, "bf16"), ("fp32", True, "fp32")):
        state, step, images, poses, ov, draws = train_step_setup(device, fused,
                                                                 precision=precision)
        params = state.parameters()
        ctx = bf16_plain_versions(dec) if label == "plain" else contextlib.nullcontext()
        with ctx:
            before = launch_counts()
            with dec.record() if label == "kernels" else contextlib.nullcontext():
                aux = step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                           overrides=ov)
            torch.cuda.synchronize()
            rec = dict(loss=float(aux["loss"]), launched=diff(before),
                       grads={str(i): p.grad.detach().clone() for i, p in enumerate(params)})

            def again():
                step(state, images, poses, torch.Generator().manual_seed(9), draws=draws,
                     overrides=ov)

            rec["ms"] = time_ms(again, 3)
        out[label] = rec
    k, p, net, f32 = (out[x] for x in ("kernels", "plain", "network", "fp32"))
    if (k["launched"] != {"fused_mlp_points_bf16": 2, "fused_mlp_bwd_bf16": 2}
            or p["launched"] or net["launched"]
            or f32["launched"] != {"fused_mlp_points": 2, "fused_mlp_bwd": 2}):
        raise AssertionError(f"step launches: {({x: out[x]['launched'] for x in out})}")
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_err = max(rel_err(k["grads"][i], p["grads"][i]) for i in p["grads"])
    vs32 = {}
    for x in ("kernels", "network"):
        r, _ = grads_close(out[x]["grads"], f32["grads"])
        vs32[x] = (max(abs(a) for a, _ in r.values()), min(c for _, c in r.values()))
    log(f"bf16 train step (lego, N_rand 1024, 64 + 128 samples, draws pinned): kernels "
        f"{k['ms']:.2f} ms, their plain versions {p['ms']:.2f} ms, the plain bf16 network "
        f"{net['ms']:.2f} ms, fp32 kernels {f32['ms']:.2f} ms; loss {k['loss']:.6f} vs the "
        f"plain versions' {p['loss']:.6f} (rel {loss_err:.1e}, tol 1e-3), worst field "
        f"gradient {grad_err:.1e} of its max (tol {BF16_TOL:g})"
        f"{dec.note(RELU_SWITCH_BF16)}; against the fp32 step "
        f"(loss {f32['loss']:.6f}): the kernel step's gradient norms within "
        f"{100 * vs32['kernels'][0]:.2f}%, lowest cosine {vs32['kernels'][1]:.6f}; the "
        f"plain bf16 network's {100 * vs32['network'][0]:.2f}%, {vs32['network'][1]:.6f}")
    if not (loss_err <= 1e-3 and grad_err <= BF16_TOL):
        raise AssertionError("the bf16 kernel training step disagrees with the step "
                             "through their plain versions")
    return {"kernel_ms": k["ms"], "plain_ms": p["ms"], "network_ms": net["ms"],
            "fp32_kernel_ms": f32["ms"], "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "kernel_vs_fp32": vs32["kernels"], "network_vs_fp32": vs32["network"]}


def bf16_serving(device, base_argv):
    """Phase 15 (c): phase 6's checkpoint served with --precision bf16 (B3
    + B5, and B4 under --fused_composite) and in fp32, one held-out pose,
    two requests each. Each bf16 frame (B3 + B5, and B4's) and its acc is
    held against its engine through the plain versions of its bf16
    kernels, at its kernel run's fine depths (inverse-CDF depths follow the
    coarse weights), within 1e-2 on the rays clear of a sentinel flip
    (held(); at most 1 in 1000 set apart), and the B4 frame within 1e-3 of
    the B3 + B5 one; the plain bf16 network's route (apply_nerf in bf16,
    which rounds in other places) is logged beside it, at those depths and
    as it is."""
    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import (
        plain_nerf_forward_rays,
        twin_nerf_forward_rays,
    )

    argv = base_argv + ["--port", "0"]
    ds = load_datasets(serve_parser().parse_args(argv))
    pose = ds.poses[int(ds.i_test[0])][:3, :4]
    res = {}
    for name, flags in (("fp32", []), ("bf16", ["--precision", "bf16"]),
                        ("bf16_fused_composite", ["--precision", "bf16",
                                                  "--fused_composite", "True"])):
        served = Served(argv + flags, ds=ds)
        try:
            zero_counts()
            status, _, body = http(served.base + "/render", {"c2w": pose.tolist(), "fmt": "npy"})
            launches = launch_counts()
            status2, _, _ = http(served.base + "/render", {"c2w": pose.tolist(), "fmt": "npy"})
        finally:
            served.close()
        frame = np.load(io.BytesIO(body))
        eng = served.service.engine
        if status != 200 or status2 != 200 or not np.isfinite(frame).all():
            raise AssertionError(f"{name}: no finite frame ({status}, {status2})")
        res[name] = dict(frame=frame, launches=launches, eng=eng,
                         ms=served.service._latencies[1] * 1e3)
    eng = res["bf16"]["eng"]
    per = math.ceil(eng.H * eng.W / eng.args.chunk)
    expect_launches("fp32 frame", res["fp32"]["launches"],
                    {"fused_mlp": 2 * per, "composite": 2 * per})
    expect_launches("bf16 frame", res["bf16"]["launches"],
                    {"fused_mlp_bf16": 2 * per, "composite": 2 * per})
    expect_launches("bf16 --fused_composite frame", res["bf16_fused_composite"]["launches"],
                    {"fused_mlp_bf16": per, "fused_render_bf16": per, "composite": per})
    c2w = torch.as_tensor(pose, dtype=torch.float32, device=device)
    def plain_bf16(params, cfg, ro, rd, zz, vd):
        return plain_nerf_forward_rays(params, cfg, ro, rd, zz, vd, torch.bfloat16)

    def network_bf16(params, cfg, ro, rd, zz, vd):
        return twin_nerf_forward_rays(params, cfg, ro, rd, zz, vd, torch.bfloat16)

    def acc_err(rgb_a, acc_a, rgb_b, acc_b):
        """max |acc_a - acc_b| over the rays held() keeps."""
        d_rgb, d_acc = np.abs(rgb_a - rgb_b).max(-1), np.abs(acc_a - acc_b)
        return float(d_acc[~((d_acc > 1e-3) & (d_rgb <= d_acc + 1e-5))].max(initial=0.0))

    eng_f = res["bf16_fused_composite"]["eng"]
    rgb_k, acc_k, z_k, _, _ = engine_maps(eng, True, c2w)
    rgb_f, acc_f, z_f, _, _ = engine_maps(eng_f, True, c2w)
    rgb_d, acc_d = plain_fine_pass(eng, pose, z_k, forward=plain_bf16)
    rgb_df, acc_df = plain_fine_pass(eng_f, pose, z_f, forward=plain_bf16)
    rgb_n, acc_n = plain_fine_pass(eng, pose, z_k, forward=network_bf16)
    rgb_p, acc_p, _, _, _ = engine_maps(eng, False, c2w)
    same = max(float(np.abs(res["bf16"]["frame"] - rgb_k).max()),
               float(np.abs(res["bf16_fused_composite"]["frame"] - rgb_f).max()))
    at_depths, n_d, flips_d = held(rgb_k, acc_k, rgb_d, acc_d)
    fused_at, n_fd, flips_fd = held(rgb_f, acc_f, rgb_df, acc_df)
    acc_at = max(acc_err(rgb_k, acc_k, rgb_d, acc_d), acc_err(rgb_f, acc_f, rgb_df, acc_df))
    net_depths, _, flips_n = held(rgb_k, acc_k, rgb_n, acc_n)
    as_is, _, flips_a = held(rgb_k, acc_k, rgb_p, acc_p)
    fused_err, n_f, flips_f = held(rgb_f, acc_f, rgb_k, acc_k)
    opaque = float((acc_df > 0.5).mean())
    p_vs32 = psnr(res["bf16"]["frame"], res["fp32"]["frame"])
    log(f"bf16 serving (phase 6's 800-step lego, {eng.W}x{eng.H}): frame "
        f"{res['bf16']['ms']:.1f} ms (B3 + B5), {res['bf16_fused_composite']['ms']:.1f} ms "
        f"(--fused_composite, B4), fp32 {res['fp32']['ms']:.1f} ms; the served frames vs "
        f"their engines' kernel routes {same:.1e}; against the plain versions of the bf16 "
        f"kernels at each kernel run's fine depths: B3 + B5 {at_depths:.2e} over {n_d} rays "
        f"({flips_d} sentinel flips set apart), B4 {fused_at:.2e} over {n_fd} rays "
        f"({flips_fd} set apart; acc > 0.5 on {100 * opaque:.1f}% of its rays), acc "
        f"{acc_at:.2e} (tol 1e-2, at most {eng.H * eng.W // 1000} set apart); vs the plain "
        f"bf16 network's route (apply_nerf in bf16) at those depths {net_depths:.2e} "
        f"({flips_n} set apart), as it is {as_is:.2e} ({flips_a} set apart); B4 frame vs "
        f"B3 + B5 {fused_err:.2e} ({flips_f} set apart; tol 1e-3); PSNR vs the fp32 frame "
        f"{p_vs32:.2f} dB (>= 30)")
    n_rays = eng.H * eng.W
    if not (same <= 1e-6 and at_depths <= 1e-2 and flips_d <= n_rays // 1000
            and fused_at <= 1e-2 and flips_fd <= n_rays // 1000 and acc_at <= 1e-2
            and fused_err <= 1e-3 and flips_f <= n_rays // 1000 and p_vs32 >= 30.0):
        raise AssertionError("the bf16 served frame fails its checks")
    return {"frame_ms": {k: v["ms"] for k, v in res.items()},
            "vs_plain_at_depths": at_depths, "flips": flips_d,
            "fused_vs_plain_at_depths": fused_at, "fused_flips": flips_fd,
            "acc_vs_plain_at_depths": acc_at, "fused_opaque_share": opaque,
            "vs_network_at_depths": net_depths, "vs_network_as_is": as_is,
            "fused_vs_b3": fused_err, "psnr_vs_fp32": p_vs32,
            "launches_by_path": {"bf16_serving": res["bf16"]["launches"],
                                 "bf16_fused_composite":
                                     res["bf16_fused_composite"]["launches"]}}


def phase_bf16(device, trained, smi, steps=600, more=200):
    """Phase 15: --precision bf16: (a) + (b) the bf16 kernels, (c) serving,
    (d) training through apps/train.main and the one-step check."""
    import re

    t0 = time.perf_counter()
    failed = []

    def attempt(what, fn, fallback):
        """fn(), or ``fallback`` with the failure kept, so that one run
        reports every check of the phase."""
        try:
            return fn()
        except AssertionError as e:
            log(f"phase 15 {what} FAILED: {e}")
            failed.append(f"{what}: {e}")
            return fallback

    cases, vs32 = attempt("(a)/(b) kernels", lambda: bf16_kernel_cases(device, trained),
                          ([], {}))
    t_a = time.perf_counter() - t0
    serving = attempt("(c) serving", lambda: bf16_serving(device, trained["base_argv"]),
                      {"launches_by_path": {}})
    t_c = time.perf_counter() - t0 - t_a

    argv = trained["base_argv"] + ["--precision", "bf16", "--expname", "lego_bf16"]
    zero_counts()
    _, text = run_train_cli(argv + ["--N_iters", str(steps)])
    _, text2 = run_train_cli(argv + ["--N_iters", str(steps + more)])
    launches = launch_counts()
    total = steps + more
    if (launches["fused_mlp_points_bf16"] != 2 * total
            or launches["fused_mlp_bwd_bf16"] != 2 * total
            or launches["fused_mlp_points"] or launches["fused_mlp_bwd"]):
        failed.append(f"bf16 training: expected {2 * total} bf16 B1 and B2 and no "
                      f"fp32 ones: {launches}")
    if "Reloading from" not in text2:
        failed.append("the resumed bf16 run did not reload its checkpoint")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text + text2)]
    vals = re.findall(r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+)", text + text2)
    val = float(vals[-1][2])
    val32 = trained["val"][-1][2]
    rate = statistics.median(rps[1:])
    ms_step = 1e3 * 1024 / rate
    log(f"bf16 training {steps} + {more} steps: median {rate:,.0f} rays/s = {ms_step:.1f} ms "
        f"a step (fp32, phase 6: {trained['rays_per_s']:,.0f} = "
        f"{trained['ms_per_step']:.1f} ms); held-out PSNR at step {vals[-1][0]} {val:.2f} dB "
        f"(fp32 {val32:.2f}, all-white {trained['white_psnr']:.2f}); launches {launches}")
    if not (int(vals[-1][0]) == total and val >= trained["white_psnr"] + 2.0
            and val >= val32 - 1.0):
        failed.append("bf16 held-out PSNR is not 2 dB above all-white or is more than "
                      "1 dB below fp32's")
    step = attempt("(d) one step", lambda: check_bf16_train_step(device), {})
    wall = time.perf_counter() - t0
    summary = {"kernels": {c["kernel"] + f" S={c['S']}": {
        k: c[k] for k in ("ms", "fp32_ms", "plain_ms", "bound_ms", "max_abs_err")}
        for c in cases}, "bf16_vs_fp32": vs32,
        "serving": {k: v for k, v in serving.items() if k != "launches_by_path"},
        "training": {"ms_per_step": ms_step, "rays_per_s": rate, "val_psnr": val,
                     "fp32_val_psnr": val32, "fp32_ms_per_step": trained["ms_per_step"]},
        "step": step, "s": {"a_b": t_a, "c": t_c, "all": wall}, "card": smi}
    log("phase 15 bf16: " + json.dumps(summary))
    if failed:
        raise AssertionError(f"phase 15: {len(failed)} check(s) failed: {failed}")
    return {"cases": cases, "launches_by_path": {**serving["launches_by_path"],
                                                 "bf16_training": launches}}


# ---- phase 16: --debug_nans, the JPEG decoder, data-parallel at world size 1 ----

JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
JPEG_RATE_FIXTURE = "s420_rate"


def timed_steps(step_once, n):
    """Run ``step_once(i)`` for i < n; each step's ms (CUDA events)."""
    import torch

    ms = []
    for i in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step_once(i)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def check_debug_nans(device, trained, steps=5):
    """Phase 16 (a): ``steps`` lego steps (train_step_setup: 1024 rays, 64 +
    128 samples, B1 + B2 twice a step) with the NaN checks off and on from
    the same state and draws: the parameters bit-equal, each run's median
    step ms (the first step, a warm-up, left out). A NaN put into B1's
    points raises FloatingPointError naming B1 (the phase fails if it does
    not). Phase 6's checkpoint served one --fused_composite frame (B4 + B5)
    with the checks on: nothing raised, a finite frame."""
    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.apps.train import build_eval_engine
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp
    from nerf_shared_tpu_torch.utils.debug import enable_nan_checks

    runs, launches = {}, {}
    for on in (False, True):
        state, step, images, poses, ov, _ = train_step_setup(device, True)
        enable_nan_checks(on)
        try:
            zero_counts()
            ms = timed_steps(lambda i: step(state, images, poses,
                                            torch.Generator().manual_seed(i), overrides=ov),
                             steps)
            launches[on] = launch_counts()
        finally:
            enable_nan_checks(False)
        runs[on] = dict(params=[p.detach().clone() for p in state.parameters()],
                        ms=statistics.median(ms[1:]))
        expect_launches(f"debug_nans {on} steps", launches[on],
                        {"fused_mlp_points": 2 * steps, "fused_mlp_bwd": 2 * steps})
    equal = all(torch.equal(a, b) for a, b in zip(runs[False]["params"], runs[True]["params"]))
    cfg, params = state.fine.cfg, {k: v.detach() for k, v in state.fine.params().items()}
    pts, vd, _ = lego_points(1024, 64, 31, device)
    pts[5, 7, 1] = float("nan")
    enable_nan_checks(True)
    try:
        try:
            fused_mlp.launch_points(params, cfg, pts, vd)
            nan_msg = None
        except FloatingPointError as e:
            nan_msg = str(e)
        argv = trained["base_argv"] + ["--fused_composite", "True", "--port", "0"]
        eng = build_eval_engine(serve_parser().parse_args(argv))
        pose = eng.ds.poses[int(eng.ds.i_test[0])][:3, :4]
        zero_counts()
        t0 = time.perf_counter()
        frame = eng.render_poses(pose[None])[0]
        frame_ms = 1e3 * (time.perf_counter() - t0)
        frame_launches = launch_counts()
    finally:
        enable_nan_checks(False)
    per = math.ceil(eng.H * eng.W / eng.args.chunk)
    expect_launches("debug_nans --fused_composite frame", frame_launches,
                    {"fused_mlp": per, "fused_render": per, "composite": per})
    log(f"phase 16 (a) --debug_nans: {steps} lego steps bit-equal with the checks on and "
        f"off: {equal}; step {runs[True]['ms']:.2f} ms on, {runs[False]['ms']:.2f} ms off "
        f"(median of steps 2-{steps}); a NaN in B1's points: {nan_msg!r}; the "
        f"--fused_composite frame with the checks on: {frame_ms:.1f} ms, finite "
        f"{bool(np.isfinite(frame).all())}, launches {frame_launches}")
    if not (equal and nan_msg and "kernel B1 (launch_points)" in nan_msg
            and np.isfinite(frame).all()):
        raise AssertionError("phase 16 (a): --debug_nans changed a clean step, missed the "
                             "NaN in B1's points or broke the frame")
    return {"step_ms_on": runs[True]["ms"], "step_ms_off": runs[False]["ms"],
            "frame_ms_on": frame_ms, "launches_by_path": {
                "debug_nans_steps": launches[True], "debug_nans_frame": frame_launches}}


def check_jpeg_fixtures(reps=5):
    """Phase 16 (b): every committed JPEG fixture (tests/data/jpeg/, written
    by Pillow) decodes to Pillow's array in fixtures.npz bit for bit (the
    480x640 rate fixture to its shape and SHA-256); the decode rate of the
    rate fixture on this machine's host, median of ``reps``."""
    import hashlib

    import numpy as np

    from nerf_shared_tpu_torch.data.jpeg import jpeg_decode

    with np.load(os.path.join(JPEG_FIXTURES, "fixtures.npz")) as z:
        want = {k: z[k] for k in z.files}
    names = sorted({k.split(".")[0] for k in want})
    bad = []
    for name in names:
        with open(os.path.join(JPEG_FIXTURES, name + ".jpg"), "rb") as f:
            got = jpeg_decode(f.read())
        if name in want:
            ok = got.shape == want[name].shape and np.array_equal(got, want[name])
        else:
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).digest()
            ok = (tuple(got.shape) == tuple(want[name + ".shape"])
                  and digest == want[name + ".sha256"].tobytes())
        if not ok:
            bad.append(name)
    with open(os.path.join(JPEG_FIXTURES, JPEG_RATE_FIXTURE + ".jpg"), "rb") as f:
        data = f.read()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        img = jpeg_decode(data)
        ts.append(time.perf_counter() - t0)
    s = statistics.median(ts)
    rate = img.shape[0] * img.shape[1] / s / 1e6
    log(f"phase 16 (b) JPEG: {len(names) - len(bad)} of {len(names)} fixtures decode to "
        f"Pillow's arrays bit for bit; {JPEG_RATE_FIXTURE} ({img.shape[1]}x{img.shape[0]} "
        f"4:2:0, {len(data)} bytes) {1e3 * s:.1f} ms [{1e3 * min(ts):.1f}-"
        f"{1e3 * max(ts):.1f}] = {rate:.3f} MPix/s on the host (12 MP at that rate: "
        f"{12 / rate:.1f} s)")
    if bad:
        raise AssertionError(f"phase 16 (b): fixtures off Pillow's decode: {bad}")
    return {"fixtures": len(names), "decode_ms": 1e3 * s, "mpix_per_s": rate}


def occ_lego_step(device, world):
    """An occ-gated step (C 64, K 32, explore 0.02) at the lego width on
    train_step_setup's scene and seeded state, its grid all occupied over
    [-2, 2]^3: (state, step(i), images, poses)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train import occ_train
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec

    state, _, images, poses, _, _ = train_step_setup(device, True)
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4, output_ch=5)
    H = W = 400
    focal = 0.5 * H / math.tan(0.5 * 0.6911112)
    spec = PixelSamplerSpec.from_K(H, W, [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                                   1024, single_image=True, precrop_iters=500,
                                   precrop_frac=0.5)
    rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64, use_viewdirs=True,
                        white_bkgd=True, near=2.0, far=6.0, fused_backward=True)
    grid = occ_train.init_density_grid([-2.0] * 3, [2.0] * 3, 64, device)
    occ = occ_train.binarize_density_grid(grid, force_occupied=True)
    fn = occ_train.make_occ_train_step(rcfg, cfg, spec, n_candidates=64, n_keep=32,
                                       world=world)
    return state, lambda i: fn(state, occ, images, poses, torch.Generator().manual_seed(i))


def check_world_of_one(device, steps=5):
    """Phase 16 (c): an NCCL process group of one rank made in this
    process (a file:// store in a temporary directory, no network), and
    ``steps`` lego steps through the data-parallel step (its gradient
    all-reduce and aux mean run) against ``steps`` through the unsharded
    step from the same state and draws: post-Adam parameters bit for bit,
    B1 + B2 launched twice a step in both; the same for the occ step (one
    B1 + one B2 a step). Median step ms (steps 2-``steps``) with and
    without the all-reduce."""
    import tempfile

    import torch

    from nerf_shared_tpu_torch.parallel import distributed

    store = tempfile.mkdtemp(dir=WORK)
    world = distributed.initialize(device, init_method=f"file://{store}/store")
    out, launches = {}, {}
    try:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if not (world.launched and world.size == 1
                and torch.distributed.get_backend() == backend):
            raise AssertionError(f"phase 16 (c): not a {backend} world of one: {world}")
        for what in ("lego", "occ"):
            res = {}
            for w in (None, world):
                if what == "lego":
                    state, step, images, poses, ov, _ = train_step_setup(device, True,
                                                                         world=w)

                    def once(i):
                        step(state, images, poses, torch.Generator().manual_seed(i),
                             overrides=ov)
                else:
                    state, once = occ_lego_step(device, w)
                zero_counts()
                ms = timed_steps(once, steps)
                counts = launch_counts()
                res[w is not None] = (
                    [p.detach().clone() for p in state.parameters()],
                    statistics.median(ms[1:]), counts)
            per = 2 if what == "lego" else 1
            for sharded in (False, True):
                expect_launches(f"{what} steps (world {sharded})", res[sharded][2],
                                {"fused_mlp_points": per * steps, "fused_mlp_bwd": per * steps})
            equal = all(torch.equal(a, b) for a, b in zip(res[False][0], res[True][0]))
            out[what] = {"equal": equal, "ms_dp": res[True][1], "ms_plain": res[False][1]}
            launches[f"dp_{what}_steps"] = res[True][2]
            log(f"phase 16 (c) world of one ({torch.distributed.get_backend()}), {steps} "
                f"{what} steps: post-Adam parameters bit-equal to the unsharded step's: "
                f"{equal}; step {res[True][1]:.2f} ms with the all-reduce, "
                f"{res[False][1]:.2f} ms without (median of steps 2-{steps})")
    finally:
        distributed.shutdown(world)
    if not all(o["equal"] for o in out.values()):
        raise AssertionError("phase 16 (c): the world-of-one step differs from the "
                             "unsharded step")
    return {**out, "launches_by_path": launches}


def phase_debug_jpeg_parallel(device, trained, smi):
    """Phase 16: (a) --debug_nans, (b) the JPEG fixtures and the decode
    rate, (c) the data-parallel steps at world size 1. One "phase 16" line."""
    t0 = time.perf_counter()
    a = check_debug_nans(device, trained)
    b = check_jpeg_fixtures()
    c = check_world_of_one(device)
    summary = {"debug_nans": {k: v for k, v in a.items() if k != "launches_by_path"},
               "jpeg": b, "world_of_one": {k: v for k, v in c.items()
                                           if k != "launches_by_path"},
               "s": time.perf_counter() - t0, "card": smi}
    log("phase 16: " + json.dumps(summary))
    return {**summary, "launches_by_path": {**a["launches_by_path"],
                                            **c["launches_by_path"]}}


def _frame_pair(label, plain_eng, sharded_eng, c2w, reps=3):
    """One pose through an unsharded engine and through its sharded twin
    (world of one): the max abs difference of rgb, bit-equal or not, both
    ms (median of ``reps``) and both launch counts. The plain engine renders
    through ``render_poses``, the sharded one through its ``render_fn``."""
    import numpy as np
    import torch

    def plain_maps():
        return plain_eng.render_poses(c2w[None])[0]

    def sharded_maps():
        return sharded_eng.render_fn(c2w, None)

    zero_counts()
    a = plain_maps()
    la = launch_counts()
    zero_counts()
    maps = sharded_maps()
    torch.cuda.synchronize()
    lb = launch_counts()
    b = maps["rgb_map"].float().cpu().numpy()
    ms_a = time_ms(plain_maps, reps)
    ms_b = time_ms(lambda: sharded_maps()["rgb_map"].cpu(), reps)
    err = float(np.abs(a - b).max())
    equal = bool(np.array_equal(a, b))
    log(f"phase 17 {label}: sharded (world of one) against unsharded: max |rgb| diff "
        f"{err:.3g}, bit-equal {equal}; {ms_b:.2f} ms sharded, {ms_a:.2f} ms unsharded "
        f"(median of {reps}); launches {_nonzero(lb)} / {_nonzero(la)}")
    return {"max_rgb_diff": err, "bit_equal": equal, "ms_sharded": ms_b, "ms_plain": ms_a,
            "launches": lb, "launches_plain": _nonzero(la)}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def phase_sharded(device, trained, smi):
    """Phase 17: the sharded renders and export in an NCCL world of one rank
    (a file:// store in a temporary directory), on phase 6's checkpoint:
    (a) the sharded dense 400x400 frame against build_eval_engine's
    unsharded frame (B3 + B5), and under --fused_composite (B4); (b) the
    sharded froxel frame (--occ_grid 128) against the unsharded froxel
    frame; (c) the sharded 129^3 probe against the unsharded probe (B1);
    (d) make_tp_apply at t = 1 against apply_nerf; (e) the engine built
    under the world reports "sharded-dense". One "phase 17" line."""
    import tempfile

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.apps.train import build_eval_engine
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.meshing import probe_density_grid
    from nerf_shared_tpu_torch.parallel import distributed
    from nerf_shared_tpu_torch.parallel.mesh import make_groups
    from nerf_shared_tpu_torch.parallel.tensor import make_tp_apply

    t_phase = time.perf_counter()
    argv = trained["base_argv"]
    ds = load_datasets(config_parser().parse_args(argv))
    c2w = np.asarray(ds.poses[int(ds.i_test[0])][:3, :4], np.float32)
    kinds = {"dense": [], "fused": ["--fused_composite", "True"],
             "froxel": ["--occ_grid", "128", "--occ_keep", "32", "--occ_fine", "16"]}

    def engine(flags):
        return build_eval_engine(config_parser().parse_args(argv + flags), ds=ds)

    plain = {k: engine(f) for k, f in kinds.items()}  # before the world: unsharded
    store = tempfile.mkdtemp(dir=WORK)
    world = distributed.initialize(device, init_method=f"file://{store}/store")
    out, launches = {}, {}
    try:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if not (world.launched and world.size == 1
                and torch.distributed.get_backend() == backend):
            raise AssertionError(f"phase 17: not a {backend} world of one: {world}")
        sharded = {k: engine(f) for k, f in kinds.items()}
        names = {k: e.engine_name for k, e in sharded.items()}
        out["e_engine_names"] = names
        if names != {"dense": "sharded-dense", "fused": "sharded-dense",
                     "froxel": "sharded-froxel"}:
            raise AssertionError(f"phase 17 (e): engines under the world: {names}")
        for k in kinds:
            r = _frame_pair(k, plain[k], sharded[k], c2w)
            launches[f"sharded_{k}_frame"] = r.pop("launches")
            out[k] = r
        n = math.ceil(plain["dense"].H * plain["dense"].W / plain["dense"].args.chunk)
        want = {"dense": {"fused_mlp": 2 * n, "composite": 2 * n},
                "fused": {"fused_mlp": n, "composite": n, "fused_render": n}}
        for k, w in want.items():
            got = _nonzero(launches[f"sharded_{k}_frame"])
            if got != w:
                raise AssertionError(f"phase 17 (a) {k}: launches {got}, expected {w}")
        if not (out["dense"]["bit_equal"] and out["fused"]["bit_equal"]):
            raise AssertionError("phase 17 (a): the sharded dense frame differs from the "
                                 "unsharded frame")
        fro = launches["sharded_froxel_frame"]
        if not (fro["fused_mlp"] > 0 and fro["composite"] > 0
                and out["froxel"]["max_rgb_diff"] <= 1e-5):
            raise AssertionError(f"phase 17 (b): froxel frame {out['froxel']}, launches {fro}")

        # (c) the probe, as the mesh CLI runs it at --mesh_res 128
        eng = plain["dense"]
        params, cfg, rcfg = eng.fine.params(), eng.fine.cfg, eng.renderer.cfg
        box = ([-1.5] * 3, [1.5] * 3)

        def probe(sharded):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sigma = probe_density_grid(params, cfg, rcfg, *box, resolution=128,
                                       mesh=world if sharded else None)
            return sigma, 1e3 * (time.perf_counter() - t0)

        zero_counts()
        s_sh = probe(True)[0]
        launches["sharded_probe"] = launch_counts()
        s_pl = probe(False)[0]
        # in turns after the warm-up: unsharded, sharded, sharded, unsharded
        ms = {True: [], False: []}
        for sharded in (False, True, True, False):
            ms[sharded].append(probe(sharded)[1])
        ms_sh, ms_pl = statistics.mean(ms[True]), statistics.mean(ms[False])
        n_blocks = math.ceil(129 ** 3 / 65536)
        out["probe"] = {"bit_equal": bool(np.array_equal(s_sh, s_pl)),
                        "max_diff": float(np.abs(s_sh - s_pl).max()),
                        "ms_sharded": ms_sh, "ms_plain": ms_pl}
        log(f"phase 17 (c) probe 129^3: sharded (world of one) against unsharded bit-equal "
            f"{out['probe']['bit_equal']}, {ms_sh:.1f} / {ms_pl:.1f} ms (host clock with the "
            f"host copy, mean of two in turns); launches {_nonzero(launches['sharded_probe'])}")
        if not out["probe"]["bit_equal"] or launches["sharded_probe"]["fused_mlp_points"] != n_blocks:
            raise AssertionError(f"phase 17 (c): {out['probe']}, {launches['sharded_probe']}")

        # (d) tensor parallelism at t = 1 against the plain network
        gen = torch.Generator(device=device).manual_seed(17)
        pts = torch.rand((1024, 64, 3), generator=gen, device=device) * 3.0 - 1.5
        vd = torch.nn.functional.normalize(
            torch.randn((1024, 3), generator=gen, device=device), dim=-1)
        apply = make_tp_apply(make_groups([1, 1], world), cfg, data_axis="data")
        with torch.no_grad():
            got, ref = apply(params, pts, vd), apply_nerf(params, cfg, pts, vd)
        out["tp"] = {"bit_equal": bool(torch.equal(got, ref)),
                     "max_diff": float((got - ref).abs().max())}
        log(f"phase 17 (d) make_tp_apply t = 1 against apply_nerf on 65,536 points: "
            f"{out['tp']}")
        if not out["tp"]["max_diff"] <= 1e-5:
            raise AssertionError(f"phase 17 (d): {out['tp']}")
    finally:
        distributed.shutdown(world)
    summary = {**out, "s": time.perf_counter() - t_phase, "card": smi}
    log("phase 17: " + json.dumps(summary))
    return {**summary, "launches_by_path": launches}


# mip-NeRF's step (phase 18): configuration mipnerf-lego, one image of
# 800x800 at lego's focal, 4096 rays x 128 intervals a pass
MIP_RAYS, MIP_S, MIP_HW = 4096, 128, 800
MIP_FOCAL = 0.5 * MIP_HW / math.tan(0.5 * 0.6911112070083618)
MIP_DESIGN = (TC_DESIGN + "; IPE encoder (IpeEnc: a Gaussian's mean, variances and view "
              "direction a point; sin / cos(f·μ)·exp(-f²σ²/2))")


def mip_args(device):
    """The mipnerf-lego flags (portbench/configs/mipnerf-lego.json) on
    ``device``."""
    from nerf_shared_tpu_torch.config import config_parser

    return config_parser().parse_args(
        ["--model_type", "mipnerf", "--dataset_type", "blender", "--use_viewdirs",
         "--white_bkgd", "--no_batching", "--N_samples", str(MIP_S),
         "--N_importance", str(MIP_S), "--N_rand", str(MIP_RAYS), "--precrop_iters", "0",
         "--device", str(device), "--no_reload"])


def mip_gaussians(n, S, seed, device):
    """A coarse pass's Gaussians [n, S, 6] on seeded lego-like rays
    (lego_rays: the radius-4 orbit): S + 1 stratified edges on [2, 6], each
    cone's base radius a pixel's of an 800x800 frame at lego's focal
    (2 / sqrt(12) of the pixel spacing |d| / focal); and the rays' unit
    directions [n, 3]."""
    import torch

    from nerf_shared_tpu_torch.ops.mip import cast_rays

    o, d, _, vd = lego_rays(n, 64, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    t = 2.0 + 4.0 * (torch.arange(S + 1) + torch.rand(n, S + 1, generator=g)) / (S + 1)
    radii = 2 / math.sqrt(12) * torch.linalg.norm(d, dim=-1, keepdim=True) / MIP_FOCAL
    return cast_rays(t, o, d, radii).to(device), vd.to(device)


def mip_faults(gauss):
    """Records under which a wrong IPE would read as the right one: without
    the variances (no attenuation, the published ``disable_integration``),
    with the mean's coordinates rotated (a column reading the wrong
    input), and a degree up (mean x 2, variances x 4: each column at the
    next column's frequency)."""
    import torch

    mean, var = gauss[..., :3], gauss[..., 3:]
    return {"unattenuated": torch.cat([mean, torch.zeros_like(var)], -1).contiguous(),
            "wrong input": torch.cat([mean.roll(1, -1), var.roll(1, -1)], -1).contiguous(),
            "degree up": torch.cat([2 * mean, 4 * var], -1).contiguous()}


def mip_grads(params, cfg, gauss, vd, g, dtype):
    """The plain network's weight gradients of sum(raw * g) in ``dtype``."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf

    with torch.enable_grad():
        leaves = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
        raw = apply_nerf(leaves, cfg, gauss.to(dtype), vd.to(dtype))
        gs = torch.autograd.grad((raw * g.to(dtype)).sum(), list(leaves.values()))
    return dict(zip(leaves, gs))


def rel_norm(got, want):
    """|got - want| / |want| in float64 (vector norms)."""
    import torch

    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def mip_bounds(cfg, params, n_rays, S):
    """(B1's, B2's) two bounds each, ((ms, by) of the design, (ms, by) on
    the fp32 CUDA cores), on n_rays x S Gaussians: B1 as points_bounds
    with 6-float records; B2 as bwd_bounds (whose tile count leaves out
    the GEMMs into the embedding under IPE: no dx) and with no dx out."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import flops_per_point_bwd

    n = n_rays * S
    f1 = flops_per_point(cfg) * n
    f2 = flops_per_point_bwd(cfg) * n
    b1 = 4 * (n_rays * 3 + n * 6 + n * 4) + network_bytes(params, cfg)
    b2 = 4 * (n_rays * 3 + n * 6 + n * 4) + 2 * network_bytes(params, cfg)
    out = []
    for flops, nbytes in ((f1, b1), (f2, b2)):
        t_bytes = nbytes / PEAK_BYTES
        pair = []
        for t_ops in (3 * flops / PEAK_TF32_FLOPS, flops / PEAK_FP32_FLOPS):
            pair.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
        out.append(tuple(pair))
    return tuple(out)


def mip_kernel_cases(device, cfg, params):
    """B1 and B2 with the IPE encoder on one pass of the step (4096 rays x
    128 Gaussians = 524,288 points) against the plain fp32 network (TF32
    off) on the same Gaussians. B1: within 2e-4 and FP32_TOL of max(1,
    max|plain|), as at lego's shapes. B2: each weight gradient within
    twice the plain fp32 route's distance to float64 (+1e-5), vector norms
    (two fp32 routes switch a ReLU at a pre-activation within rounding of
    0 each their own way). Each of mip_faults' records, through the plain
    network, has to miss both tolerances, or the check could not see it.
    Times in turns with the plain versions beside both bounds."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    n, S = MIP_RAYS, MIP_S
    gauss, vd = mip_gaussians(n, S, 18, device)
    g = torch.randn(n, S, 4, generator=torch.Generator().manual_seed(19)).to(device)
    with torch.no_grad():
        raw = fused_mlp.launch_points(params, cfg, gauss, vd)
        plain = apply_nerf(params, cfg, gauss, vd)
        want = apply_nerf({k: v.double() for k, v in params.items()}, cfg, gauss.double(),
                          vd.double())
        e1, ok1 = abs_err(raw, plain, 2e-4, fp32=True)
        tol1 = FP32_TOL * max(1.0, float(plain.abs().max()))
        faults1 = {k: float((apply_nerf(params, cfg, f, vd) - plain).abs().max())
                   for k, f in mip_faults(gauss).items()}
    e1_64, p1_64 = rel_norm(raw, want), rel_norm(plain, want)
    del want
    grads, dpts, ddirs = fused_mlp_bwd.launch_backward(params, cfg, gauss, vd, g)
    if dpts is not None or ddirs is not None:
        raise AssertionError("B2's IPE instantiation returned input gradients")
    g64 = mip_grads(params, cfg, gauss, vd, g, torch.float64)
    g32 = mip_grads(params, cfg, gauss, vd, g, torch.float32)
    tol2 = {k: 2 * rel_norm(g32[k], g64[k]) + 1e-5 for k in g64}
    errs2 = {k: rel_norm(grads[k], g64[k]) for k in g64}
    vs_plain2 = max(rel_norm(grads[k], g32[k]) for k in g32)
    e2 = max(float((grads[k].double() - g64[k]).abs().max()) for k in g64)
    faults2 = {}
    for name, f in mip_faults(gauss).items():
        gf = mip_grads(params, cfg, f, vd, g, torch.float32)
        faults2[name] = max(rel_norm(gf[k], g64[k]) / tol2[k] for k in g64)
    del g64, g32
    torch.cuda.synchronize()
    worst = max(errs2, key=lambda k: errs2[k] / tol2[k])
    log(f"  mip B1 IPE N={n * S}: max err {e1:.1e} vs the plain fp32 network (tol "
        f"{tol1:.1e}: FP32_TOL x max(1, max|plain|)); vs float64 {e1_64:.1e}, the plain "
        f"route {p1_64:.1e} (vector norms); the faults through the plain network miss it "
        f"by " + ", ".join(f"{k} {v:.1e}" for k, v in faults1.items()))
    log(f"  mip B2 IPE N={n * S}: worst leaf {worst} {errs2[worst]:.1e} from float64 (tol "
        f"{tol2[worst]:.1e}: 2x the plain fp32 route's + 1e-5); vs the plain fp32 route "
        f"worst {vs_plain2:.1e}; the faults' worst leaf at " +
        ", ".join(f"{k} {v:.0f}x" for k, v in faults2.items()) + " its tolerance")
    if not ok1:
        raise AssertionError(f"mip B1 IPE disagrees with the plain network: {e1:.1e}")
    if any(errs2[k] > tol2[k] for k in errs2):
        raise AssertionError(f"mip B2 IPE disagrees with float64: {errs2}")
    if min(faults1.values()) <= tol1 or min(faults2.values()) <= 1.0:
        raise AssertionError(f"a fault of the IPE passes the check: {faults1}, {faults2}")
    with torch.no_grad():
        t1, tp1 = in_turns(lambda: fused_mlp.launch_points(params, cfg, gauss, vd),
                           lambda: apply_nerf(params, cfg, gauss, vd), rounds=3, reps=5)
        # B1's IPE training launch (it writes H) on its own
        t1h = time_ms(lambda: fused_mlp_bwd.forward_saving_h(params, cfg, gauss, vd), 3)
    # B2 alone, over an H made outside the timed calls
    saved = fused_mlp_bwd.forward_saving_h(params, cfg, gauss, vd)[1]

    def b2():
        return fused_mlp_bwd.launch_backward(params, cfg, gauss, vd, g, saved=saved)

    t2, tp2 = in_turns(b2, lambda: mip_grads(params, cfg, gauss, vd, g, torch.float32),
                       rounds=3, reps=3)
    parts = kernels_ms(b2, 3, ("nerf_bwd_ipe_kernel", "nerf_dw_kernel", "grad_reduce_kernel"))
    del saved
    ((b1, by1), (f1, fby1)), ((b2, by2), (f2, fby2)) = mip_bounds(cfg, params, n, S)
    cases = []
    for kernel, t, tp, b, by, f, err, extra in (
            ("fused_mlp_points_ipe", t1, tp1, b1, by1, f1, e1,
             dict(design=MIP_DESIGN, fault_errs=faults1, train_ms=t1h)),
            ("fused_mlp_bwd_ipe", t2, tp2, b2, by2, f2, e2,
             dict(design=B2_DESIGN + "; the tile over H from B1's IPE training launch, no "
                  "dx (nerf_bwd_ipe_kernel)", max_rel_err=errs2[worst],
                  tile_ms=parts["nerf_bwd_ipe_kernel"], dw_ms=parts["nerf_dw_kernel"],
                  reduce_ms=parts["grad_reduce_kernel"], fault_over_tol=faults2))):
        verdict = "beats" if t[2] < tp[1] else "loses to" if t[1] > tp[2] else "ties"
        log(f"{kernel} N={n * S}: {spread(t)} ms vs plain {spread(tp)} ms ({verdict} it; "
            f"median [min-max] in turns); bound {b:.2f} ms split fp32 on the tensor cores "
            f"({by}), {f:.2f} ms fp32 on the CUDA cores; {100 * b / t[0]:.1f}% of the "
            f"design's bound" + (f"; over B1's saved H (the plain route runs its own "
                                 f"forward): tile {parts['nerf_bwd_ipe_kernel']:.3f}, dW "
                                 f"{parts['nerf_dw_kernel']:.3f} ms (profiler)"
                                 if kernel == "fused_mlp_bwd_ipe" else
                                 f"; its training launch (writing H) {t1h:.4f} ms"))
        cases.append(dict(kernel=kernel, S=S, n_points=n * S, max_abs_err=err, ms=t[0],
                          ms_min=t[1], ms_max=t[2], plain_ms=tp[0], plain_min=tp[1],
                          plain_max=tp[2], bound_ms=b, bound_by=by,
                          bound_fp32_cuda_cores_ms=f, vs_plain=verdict, **extra))
    return cases


def mip_train_step(device, params):
    """One mipnerf-lego training step (4096 rays of one 800x800 image x
    (128 + 128) intervals) through make_train_step as apps/train.py builds
    it, after a first step that builds the kernels: the launch counters
    reset just before it and read after it (2 B1 IPE, 2 B2 IPE, 1,048,576
    Gaussians encoded, no other kernel), under
    ``set_sync_debug_mode("error")``; then the device ms of 5 steps."""
    import dataclasses

    import torch

    from nerf_shared_tpu_torch.config import resolve_fused_backward
    from nerf_shared_tpu_torch.factory import (
        coarse_loss_weight, get_renderer, get_train_state, nerf_configs)
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.step import make_train_step

    args = mip_args(device)
    ccfg, fcfg = nerf_configs(args)
    state = get_train_state(args, device, cfgs=(ccfg, fcfg))
    with torch.no_grad():
        for k, v in state.coarse.params().items():
            v.copy_(params[k])
    rcfg = dataclasses.replace(get_renderer(args, {"near": 2.0, "far": 6.0}, device).cfg,
                               use_pallas=False, fused_composite=False,
                               fused_backward=resolve_fused_backward(args, device))
    K = [[MIP_FOCAL, 0.0, MIP_HW / 2], [0.0, MIP_FOCAL, MIP_HW / 2], [0.0, 0.0, 1.0]]
    spec = PixelSamplerSpec.from_K(MIP_HW, MIP_HW, K, MIP_RAYS, single_image=True)
    step = make_train_step(rcfg, ccfg, fcfg, spec, coarse_weight=coarse_loss_weight(args))
    g = torch.Generator().manual_seed(18)
    images = torch.rand(2, MIP_HW, MIP_HW, 3, generator=g).to(device)
    poses = torch.eye(4)[:3].repeat(2, 1, 1)
    poses[:, :, 3] = torch.tensor([0.0, 0.0, 4.0])
    poses = poses.to(device)
    step(state, images, poses, g)
    torch.cuda.synchronize()
    zero_counts()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = step(state, images, poses, g)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    launches, points, saved = launch_counts(), fused_mlp.IPE_POINTS, fused_mlp.SAVED_H_POINTS
    want = {"fused_mlp_points_ipe": 2, "fused_mlp_bwd_ipe": 2}
    expect_launches("mip step", launches, want)
    if (points != 2 * MIP_RAYS * MIP_S or saved != points
            or not bool(torch.isfinite(aux["loss"]))):
        raise AssertionError(f"mip step: {points} Gaussians encoded, H of {saved}, "
                             f"loss {aux['loss']}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        step(state, images, poses, g)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    log(f"  mip step: launches {_nonzero(launches)}, {points:,} Gaussians encoded, H of "
        f"{saved:,} written by B1 for B2, no host "
        f"sync (set_sync_debug_mode error), loss {float(aux['loss']):.4f}; {ms:.2f} ms a "
        f"step over 5 ({MIP_RAYS * 1e3 / ms:,.0f} rays/s)")
    return {"mip_train_step": launches}, {"ms_per_step": ms, "ipe_points": points,
                                          "saved_h_points": saved}


def phase_mip(device, smi):
    """Phase 18: mip-NeRF (--model_type mipnerf, the mipnerf-lego
    configuration): B1's and B2's IPE instantiations against the plain
    network at the step's shapes, and one training step's launches."""
    import torch

    from nerf_shared_tpu_torch.factory import nerf_configs
    from nerf_shared_tpu_torch.models.nerf import NeRF

    cfg, _ = nerf_configs(mip_args(device))
    # He-uniform weights (sqrt(6) x torch's init), as the benchmark's: at
    # torch's init a deep ReLU network's outputs all but vanish
    params = {k: (v * (math.sqrt(6) if k.endswith("weight") else 1.0)).detach()
              for k, v in NeRF(cfg, device=device,
                               generator=torch.Generator().manual_seed(18)).params().items()}
    cases = mip_kernel_cases(device, cfg, params)
    by_path, step = mip_train_step(device, params)
    entries = [kernel_entry(c["kernel"], [c], by_path) for c in cases]
    log("phase 18: " + json.dumps({"card": smi, "step": step, "kernels": [
        {k: e[k] for k in ("name", "launches", "launches_by_path", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by")} for e in entries]}))
    return {"cases": cases, "launches_by_path": by_path, "step": step}


# each kernel of the kernels line: (its source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "fused_mlp_points": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                         "nerf_shared_tpu/ops/pallas/fused_mlp.py:253"),
    "fused_mlp_bwd": ("nerf_shared_tpu_torch/csrc/fused_mlp_bwd.cu",
                      "nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py:176"),
    "fused_mlp": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                  "nerf_shared_tpu/ops/pallas/fused_mlp.py:280"),
    "fused_render": ("nerf_shared_tpu_torch/csrc/fused_render.cu",
                     "nerf_shared_tpu/ops/pallas/fused_render.py:80"),
    "composite": ("nerf_shared_tpu_torch/csrc/composite.cu",
                  "nerf_shared_tpu/ops/pallas/composite.py:37"),
    "gather": ("nerf_shared_tpu_torch/csrc/gather.cu",
               "benchmarks/scatter_probe.py:104"),
    "scatter_add": ("nerf_shared_tpu_torch/csrc/gather.cu",
                    "benchmarks/scatter_probe.py:134"),
    # the bf16 instantiations of B1, B2, B3 and B4 (--precision bf16)
    "fused_mlp_points_bf16": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                              "nerf_shared_tpu/ops/pallas/fused_mlp.py:253"),
    "fused_mlp_bwd_bf16": ("nerf_shared_tpu_torch/csrc/fused_mlp_bwd.cu",
                           "nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py:176"),
    "fused_mlp_bf16": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                       "nerf_shared_tpu/ops/pallas/fused_mlp.py:280"),
    "fused_render_bf16": ("nerf_shared_tpu_torch/csrc/fused_render.cu",
                          "nerf_shared_tpu/ops/pallas/fused_render.py:80"),
    # the IPE instantiations of B1 and B2's tile (--model_type mipnerf)
    "fused_mlp_points_ipe": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                             "nerf_shared_tpu/ops/pallas/fused_mlp.py:253"),
    "fused_mlp_bwd_ipe": ("nerf_shared_tpu_torch/csrc/fused_mlp_bwd.cu",
                          "nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py:176")}


def kernel_entry(name, mine, by_path):
    """The kernels line's entry of kernel ``name`` from its cases ``mine``
    and the launch counts ``by_path`` (path -> launch_counts())."""
    src, replaces = KERNEL_SOURCES[name]
    # the main path's shape: the largest sample count, or for P1 / P2
    # split L8/F8 level 3 in the fine pass on main-path indices
    main_case = (max((c for c in mine if "path" not in c), key=lambda c: c["S"])
                 if "S" in mine[0] else next(c for c in mine if c["main"]))
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(p.get(name, 0) for p in by_path.values()),
        "launches_by_path": {k: p.get(name, 0) for k, p in by_path.items()},
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case.get("library_ms"),
        **{k: main_case[k] for k in ("design", "bound_fp32_cuda_cores_ms",
                                     "bound_design_ms", "bound_tile_cuda_cores_ms", "fp32_ms")
           if k in main_case},
        "cases": mine,
    }


def _profile(what, fn, top_n=8):
    """fn() under torch.profiler: device time by kernel (the ``top_n``
    largest) and the device's busy share of the wall time. The program's
    spans (utils/profiling.py) record under any profiler, and each one's
    ``record_function`` shows on the device's row as a user annotation
    over the kernels it launched: those are not device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    log(f"profile {what}: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, ms in top:
        log(f"  {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    table = {k: sum(ms for name, ms in by_name.items() if prefix in name)
             for k, prefix in (("P1", "p1_gather_rows"), ("P2", "p2_scatter_add_rows"))}
    if any(table.values()):
        log("  " + ", ".join(f"{k} {ms:.2f} ms = {100 * ms / busy:.1f}% of device time"
                             for k, ms in table.items()))


# the tensor-core kernels of each library and their MMA instruction: B1,
# B3, B4 and B2's tile kernel on warpgroup MMAs (HGMMA), B2's dW kernel on
# warp MMAs (HMMA); each in fp32 (split) and bf16
TC_KERNELS = {"fused_mlp": [("HGMMA", ("nerf_points_tc_kernel", "nerf_rays_tc_kernel",
                                       "nerf_points_bf16_kernel", "nerf_rays_bf16_kernel",
                                       "nerf_points_ipe_kernel"))],
              "fused_render": [("HGMMA", ("nerf_render_tc_kernel", "nerf_render_bf16_kernel"))],
              "fused_mlp_bwd": [("HGMMA", ("nerf_bwd_kernel<true>", "nerf_bwd_kernel<false>",
                                           "nerf_bwd_bf16_kernel", "nerf_bwd_ipe_kernel")),
                                ("HMMA", ("nerf_dw_kernel", "nerf_dw_bf16_kernel"))]}


def demangled(name):
    """The nested name of an Itanium-mangled symbol (nstt::nerf_dw_kernel),
    with its bool template arguments (nstt::tc::nerf_points_tc_kernel<true>),
    or the symbol as it is."""
    import re

    i = 2 if name.startswith("_Z") else 0
    if name[i:i + 1] == "N":
        i += 1
    parts = []
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        k = int(name[i:j])
        parts.append(name[j:j + k])
        i = j + k
    m = re.match(r"I((?:Lb[01]E)+)E", name[i:])
    args = "<" + ", ".join("true" if b == "1" else "false"
                           for b in re.findall(r"Lb([01])E", m.group(1))) + ">" if m else ""
    return "::".join(parts) + args if parts else name


def check_tensor_cores(parent=False):
    """B1, B3, B4 and both of B2's kernels run on the tensor cores: each
    kernel of TC_KERNELS is in its library's SASS and holds its MMA
    instruction (HGMMA: Hopper's warpgroup MMA; HMMA: the warp MMA), and
    so does every other ``*_tc_kernel`` there. Raises otherwise. (The
    wrappers launch only those kernels: B1's, B3's and B4's C entries are
    the ``_tc`` ones, and B2's entry launches nerf_bwd_kernel and
    nerf_dw_kernel.) ``parent``: the tree is the parent side of an A/B
    (ab_smoke.sh), which may predate a kernel of TC_KERNELS or its move to
    the tensor cores; such a kernel is logged, not held."""
    from nerf_shared_tpu_torch.ops.cuda import common

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, wanted_ops in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(common.build([name])[name])],
                              capture_output=True, text=True, check=True).stdout
        for op, wanted in wanted_ops:
            kernels = {}
            current = None
            for line in sass.splitlines():
                if "Function :" in line:
                    current = demangled(line.split("Function :")[1].strip())
                    kernels[current] = 0
                elif current and op in line:   # "HGMMA" does not hold "HMMA"
                    kernels[current] += 1
            log(f"  SASS {name}: {op} instructions by kernel {kernels}")
            for want in wanted:
                if not any(want in k and n > 0 for k, n in kernels.items()):
                    if parent:
                        log(f"  SASS {name}: {want} has no {op} in the parent tree")
                    else:
                        raise AssertionError(f"{name}: {want} is missing or holds no {op}")
            if op == "HGMMA" and not parent and any(
                    ("_tc_kernel" in k or "bf16_kernel" in k) and "dw" not in k and n == 0
                    for k, n in kernels.items()):
                raise AssertionError(f"{name}: a tensor-core kernel holds no {op}")


def profile_frame(eng, pose):
    """One dense frame under torch.profiler."""
    import torch

    eng.render_poses(pose[None])
    torch.cuda.synchronize()
    _profile("dense frame", lambda: eng.render_poses(pose[None]))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from nerf_shared_tpu_torch.ops.cuda import common
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = "cuda"
    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    t0 = time.perf_counter()
    common.build()
    log(f"phase 1: built {', '.join(common.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in common.BUILD_LOG.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line and "'" in line:
                kernel = demangled(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")
    only = None
    if "--phases" in sys.argv[1:]:
        only = {int(p) for p in sys.argv[sys.argv.index("--phases") + 1].split(",")}
    # the parent side of an A/B (ab_smoke.sh); only with --phases
    check_tensor_cores(parent=only is not None and "--parent-tree" in sys.argv[1:])
    profile = "--profile" in sys.argv[1:]

    def want(*phases):
        return only is None or any(p in only for p in phases)

    cases = []
    if want(2):
        t0 = time.perf_counter()
        cases += phase_kernels(device) + check_composite(device)
        log(f"phase 2: kernels vs plain versions in {time.perf_counter() - t0:.1f} s")
    if want(3, 4):
        t0 = time.perf_counter()
        served = phase_serving(device)
        log(f"phase 3+4: serving in {time.perf_counter() - t0:.1f} s")
    if want(5):
        t0 = time.perf_counter()
        train_cases, step = phase_train_kernels(device)
        cases += train_cases
        log(f"phase 5: training kernels in {time.perf_counter() - t0:.1f} s")
    if want(6, 7, 11, 12, 13, 14, 15, 16, 17):
        t0 = time.perf_counter()
        trained = phase_training(device)
        log(f"phase 6: training in {time.perf_counter() - t0:.1f} s")
    if want(7):
        t0 = time.perf_counter()
        fast = phase_fast_serving(device, trained["base_argv"], profile=profile)
        log(f"phase 7: fast serving in {time.perf_counter() - t0:.1f} s")
    if want(8):
        t0 = time.perf_counter()
        gather_cases, probe = phase_gather(device)
        cases += gather_cases
        log(f"phase 8: gather kernels and the probe in {time.perf_counter() - t0:.1f} s")
    if want(9):
        t0 = time.perf_counter()
        grid = phase_grid(device, profile=profile)
        log(f"phase 9: grid families in {time.perf_counter() - t0:.1f} s")
    if want(10, 14):
        t0 = time.perf_counter()
        llff = phase_llff(device)
        log(f"phase 10: LLFF (fern recipe) in {time.perf_counter() - t0:.1f} s")
    if want(11):
        t0 = time.perf_counter()
        pose = phase_pose(device, trained)
        cases += pose["cases"]
        log(f"phase 11: camera poses in {time.perf_counter() - t0:.1f} s")
    if want(12):
        t0 = time.perf_counter()
        proposal = phase_proposal(device, trained, smi)
        log(f"phase 12: the proposal sampler, loss sampling and EMA in "
            f"{time.perf_counter() - t0:.1f} s")
    if want(13):
        t0 = time.perf_counter()
        occ = phase_occ(device, trained, smi)
        log(f"phase 13: the occupancy-gated trainer in {time.perf_counter() - t0:.1f} s")
    if want(14):
        t0 = time.perf_counter()
        mesh = phase_mesh(device, trained, llff)
        log(f"phase 14: mesh export in {time.perf_counter() - t0:.1f} s")
    if want(15):
        t0 = time.perf_counter()
        bf16 = phase_bf16(device, trained, smi)
        cases += bf16["cases"]
        log(f"phase 15: --precision bf16 in {time.perf_counter() - t0:.1f} s")
    if want(16):
        t0 = time.perf_counter()
        p16 = phase_debug_jpeg_parallel(device, trained, smi)
        log(f"phase 16: --debug_nans, JPEG and data parallel in "
            f"{time.perf_counter() - t0:.1f} s")
    if want(17):
        t0 = time.perf_counter()
        p17 = phase_sharded(device, trained, smi)
        log(f"phase 17: sharded renders and export in {time.perf_counter() - t0:.1f} s")
    if want(18):
        t0 = time.perf_counter()
        mip = phase_mip(device, smi)
        cases += mip["cases"]
        log(f"phase 18: mip-NeRF's IPE kernels and step in {time.perf_counter() - t0:.1f} s")
    if profile:
        if want(3, 4):
            profile_frame(served["engine"], served["pose"])
        if want(5, 6, 12):
            profile_train_step(device)
        if want(12):
            profile_proposal_step(device)
        if want(13):
            profile_occ_step(device, trained)
        if want(9):
            profile_grid_step(device)
            profile_grid_step(device, vertex=True)
        if want(10):
            profile_train_step(device, recipe="fern")
            _profile("fern frame", lambda: llff["engine"].render_poses(llff["pose"][None]))
    if only is not None:
        log(f"phases {sorted(only)} done in {time.perf_counter() - t_script:.1f} s "
            "(no result lines with --phases)")
        return 0
    by_path = dict(served["launches"])
    by_path["training"] = trained["launches"]
    by_path["render_only"] = trained["render_launches"]
    for name, *_ in FAST_ENGINES:  # the engine's build (the grid) and its request
        r = fast[name]
        by_path[name] = {k: r["build_launches"][k] + r["launches"][k] for k in r["launches"]}
    by_path.update(grid["launches_by_path"])
    by_path.update(llff["launches_by_path"])
    by_path.update(pose["launches_by_path"])
    by_path.update(proposal["launches_by_path"])
    by_path.update(occ["launches_by_path"])
    by_path.update(mesh["launches_by_path"])
    by_path.update(bf16["launches_by_path"])
    by_path.update(p16["launches_by_path"])
    by_path.update(p17["launches_by_path"])
    by_path.update(mip["launches_by_path"])

    kernels = [kernel_entry(name, [c for c in cases if c["kernel"] == name], by_path)
               for name in KERNEL_SOURCES]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    log(json.dumps({"frame_ms": served["frame_ms"], "train_step": step, "fast": fast,
                    "training": {k: trained[k] for k in (
                        "ms_per_step", "rays_per_s", "train_psnr", "val", "white_psnr")},
                    "grid": {k: v for k, v in grid.items() if k != "launches_by_path"},
                    "llff": {k: v for k, v in llff.items()
                             if k not in ("launches_by_path", "engine", "pose")},
                    "pose": {k: v for k, v in pose.items()
                             if k not in ("launches_by_path", "cases")},
                    "proposal": {k: v for k, v in proposal.items()
                                 if k != "launches_by_path"},
                    "occ": {k: v for k, v in occ.items() if k != "launches_by_path"},
                    "mesh": {k: v for k, v in mesh.items() if k != "launches_by_path"},
                    "bf16_launches": bf16["launches_by_path"],
                    "phase16": {k: v for k, v in p16.items() if k != "launches_by_path"},
                    "phase17": {k: v for k, v in p17.items() if k != "launches_by_path"},
                    "mip": mip["step"],
                    "probe": probe}))
    log(f"all phases in {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
