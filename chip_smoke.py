#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device   the card's name, and nvidia-smi's name and power limit;
  2. build    nvcc builds the kernels from videorenderer_tpu_torch/csrc;
  3. K1       banded W resize vs its plain version at the 4K headline shapes
              (mid16 codes within 1, float32 within 2e-5);
  4. K2       H resize + tail vs its plain version at the headline shapes,
              headline epilogue, R10G10B10A2 (within 1 code on < 2%);
  5. slice    VideoProcessor 4K P010 HDR10 -> 1080p SDR RGB10, three
              distinct batches of 16 frames and one of 1: >= 55 dB against
              the float64 oracle, K1 launched 3 times and K2 once per call,
              ms/frame of the kernel path and of the plain path;
  6. c1       1080p NV12 -> RGBA8 1:1 dithered (K2 reads the luma directly):
              >= 55 dB against the oracle;
  7. K6       raw NV12 -> Jinc2-upscaled RGBA8 vs its plain version on 2
              frames at the c3 shapes (1080p -> 4K), with and without the
              transposed store, and at c3rot's (2160 x 3840, 9/8 across,
              32/9 down, transposed) (within 1 code on < 1% of the
              channels); the per-output route (the table cap at 0) on c3's
              call, bit-equal to the table route, and timed beside it;
  8. K5       float Jinc2 vs its plain version at (6, 1080, 1920) ->
              (2160, 3840), float (within 1e-5), dithered and rounded (1
              code, < 1%); the dithered call on the per-output route (the
              table cap at 0), bit-equal to the table route, both timed;
              K5 timed at c3r270's batch (48 planes);
  9. c3       VideoProcessor 1080p NV12 -> 4K RGBA8 Jinc2, dithered, two
              distinct batches of 16: the first call builds the geometry's
              weight table (one table launch beside K6's), every later call
              is one K6 launch and nothing else, >= 55 dB against the
              float64 Jinc2 oracle, ms/frame; K6's time at batch 16;
 10. c3rot    make_frame_fn(plan, rotation=90, flip=True) of the 2160 x
              3840 plan: its first call builds its table, then one K6
              launch a call (the transposed store), bit-equal to the
              transposed unrotated surface, >= 55 dB against the rotated
              oracle; the table kernel at c3rot's 32 x 9 classes against
              its plain version, timed;
 11. c3r270   the c3 plan with rotation 270: first its convert on 2 frames
              against the plain versions (K1 on the uint8 chroma, float
              within 2e-5; K2 with the colour matrix only, float within
              1e-5), then the route, K1 x2 + K2 x1 + K5 x1 per call and the
              rotation of the surface; >= 55 dB; the surface's digest.  K5
              and K6 share c3's weight table: with the tables dropped, the
              route's first call builds it and c3's next call builds none,
              and the other way round;
 12. K7       deinterlace of both fields + H resize vs its plain version
              on 2 frames at c5's shapes (4K P010 -> 1080 rows), top and
              bottom field first, prev == next on the left half (float32
              within 2e-5); timed on a 16-frame window;
 13. K9       W resize + c5's HLG -> SDR tail + RGBA8 vs its plain version
              on K7's 2-frame output read as 4 fields (within 1 code on
              < 2% of the channels); timed on 32 fields, and its tail and
              store alone (the same epilogue on 1920-wide planes read
              directly, no W map);
 14. c5       DeinterlaceSession(plan, double_rate=True, pack_surface=True)
              on 4K P010 HLG interlaced -> 1080p RGBA8: two distinct
              batches of 16 through push_batch, then flush_batch, K7 x1 +
              K9 x1 per step and nothing else; field 0 and field 1 of
              stream frame 0 (prev clamped to it) >= 55 dB against
              oracle_deint; ms per field back to back and per frame at batch
              1; the plain path's ms per field; and single rate,
              make_deint_frame_fn at batch 16: K1 x3 + K2 x1 per call,
              >= 55 dB, and on 2 frames each of those calls (K1 on the
              float32 deinterlaced planes, K2 with the HLG tail and RGBA8)
              against its plain version on the same inputs (K1 mid16
              within 1 code, float32 within 2e-5; K2 within 1 code on < 2%
              of the channels).
 15. K8       c8's serving function on 2 frames with scene 2's curves, for
              c8's metadata and a variant where neither the reshape nor the
              LMS step folds: its K8 call against rows3_mid_plain on the
              same inputs (float32 within 1e-5, the variant 1e-4; the
              curves it was given are the scene's) and its K9 call against
              cols3_tail_plain (within 1 code on < 2%);
 16. K3       the calls the letterboxed plan's K1 + K3 route made before
              the offset tail, on 2 frames (each plane's K1 float32 output
              of the plan's maps), and raw uint16 luma with the
              normalisation in the taps, against banded_resize_rows_plain
              (within 2e-6), with the digests of both (K3's path is the
              GRAY source's now: phase 27);
 17. c8       make_serving_fn of 4K P010 Dolby Vision -> 1080p RGB10: four
              scenes of 16 frames, each its own curves, K1 x2 + K8 x1 + K9
              x1 per call and nothing else, no build or library load
              between scenes; frame 0 of scene 0 and of scene 3, and the
              variant, >= 55 dB against oracle_dovi; ms/frame back to back
              and synced, batch 1 synced median of 15 calls, the plain
              path's ms/frame (>= 55 dB too); K8's and K9's times at c8's
              batch, K8's on the variant's call (its LMS route), K9's tail
              and store alone (planes read directly), and
              K9's bound there (the three float32 mid planes and the RGB10
              output over the memory rate, against its W taps' FMAs);
 18. letterbox  VideoProcessor 3840 x 1608 (a 2.39:1 film) -> the
              (0, 138, 1920, 942) rect of a 1920 x 1080 RGB10 surface, two
              distinct batches of 16: K1 x3 + K2 x1 per call (K2 stores at
              the rect's origin) and nothing else, the rect bit-equal to
              the unplaced 1920 x 804 plan's surface, every dword outside
              the rect the packed zero, >= 55 dB against the oracle with
              placement (the rect and the whole surface); ms/frame; the
              same checks on 2 frames of a 4:3 film (2880 x 2160)
              pillarboxed into (240, 0, 1680, 1080) and of the headline
              source in (2, 1, 1918, 1079), a column offset that is not a
              multiple of 4.
 19. K4       the whole fused pipeline in one kernel on the fused plans'
              own maps and tails, the headline (PQ -> SDR), c7 (BT.2390
              with scene 2's values) and the headline source to a 160 x 90
              Lanczos thumbnail (K4's long-window route), on 2 frames:
              against mega3_tail_plain and against the two-stage route with
              float32 intermediates (TexFormat.FLOAT16: K1 then K2,
              unpacked), dithered float within 1 code on < 2% of the
              channels; with the colour matrix only, float32 within 1e-5;
              the compiled tail route each takes; the long-window route
              forced on the headline and c7, bit-equal to the staged one;
              then at batch 16, one launch per plan counted, timed (one
              launch a call checked) on each route and at each staged
              tile height of K4_TILES that fits (bit-equal across them)
              beside the two-stage route (mid16, unpacked and packed) on
              the same inputs;
 20. c7       make_serving_fn of 4K P010 HDR10 -> 4K RGB10 PQ for a
              600-nit display (BT.2390 local tone map): four scenes of 16
              frames, each its own HDR10 values, K1 x2 + K2 x1 per call and
              nothing else, no build or library load between scenes; frame
              0 of scene 0 and of scene 3 >= 55 dB against oracle_c7; the
              static route (VideoProcessor, the plan's metadata) >= 55 dB;
              the path's K1 and K2 calls on 2 frames against their plain
              versions (K1 mid16 within 1 code, K2 within 1 code on < 2%);
              ms/frame back to back and synced, batch 1 synced median and
              p90 of 15 calls, the plain path's ms/frame (>= 55 dB too).
 21. probe    K10, the W-pass probe, against its plain versions on 2
              headline frames (wpass_floor bit-equal, wpass_bf16 within
              1e-5, its digest); then at batch 16
              torch_headline_micro.py's W-pass probe (yW, yW1, yWsplit,
              memcpy) and its stage split of the
              headline and of c7 (yW, cW, tail, tailID, tailH, tailNoPack,
              full, the tower, matrix and pack attribution), each run counted: K1 + K10
              x2 per probe round, K1 and K2 per stage; tail on the yW/cW
              outputs bit-equal to the FLOAT16 make_frame_fn of the plan.
 22. thumb    VideoProcessor of the headline source -> 160 x 90 RGB10 (a
              4K thumbnail, Hamming at 24:1), two distinct batches of 16:
              K1 x3 + K2 x1 a call, K2 on its long-window route, K2's call
              against its plain version (within 1 code on < 2%), >= 55 dB;
              ms/frame; K2's long-window route forced on the headline's
              own shapes (2 frames) bit-equal to the staged route, both
              timed.
 23. c5_small DeinterlaceSession(double_rate=True) of c5's source -> 320 x
              180 RGBA8: two batches of 16 and the flush, K7 x1 + K9 x1 a
              step, K7 on its long-window route (K9's spans, 219 KB, still
              fit: its route is printed, and its long-window route forced
              on the same call is bit-equal), each against its plain
              version (K7 f32 within 2e-5; K9 within 1 code on < 2%), both
              fields >= 55 dB; ms/field; each route forced on c5's own
              1080p shapes (2 frames) bit-equal to the staged one.
 24. c8_small c8's serving function -> 320 x 180 RGB10, two scenes: K1 x2
              + K8 + K9 a call (K9 on its long-window route), K8 and K9
              against their plain versions, >= 55 dB; ms/frame.
 25. c8_rect  c8's four scenes into the (320, 180, 1600, 900) rect of a
              1920 x 1080 RGB10 surface: K1 x2 + K8 + K9 with the offset a
              call, the rect bit-equal to the unplaced 1280 x 720 plan's
              surface, the bars the packed zero, scenes 0 and 3 >= 55 dB;
              ms/frame.
 26. sdr2020  4K P010 SDR with BT.2020 primaries (BT.1886) -> 1080p RGB10
              dithered: K1 x3 + K2 a call with CORR_FIX_BT2020, K2's call
              against its plain version (within 1 code on < 2%), >= 55 dB;
              ms/frame.
 27. gray     4K Y16 -> 1080p RGB10 dithered: K1 + K3 a call, K3's call
              against its plain version (within 2e-6) and timed with the
              library call (K3's numbers in the kernels line), >= 55 dB;
              ms/frame.
 28. shader   the headline plan with vp_scaling=False: K1 x2 + K2 (the
              convert at source resolution with PQ -> SDR, float32 out) a
              call, then the torch resize and final pass; the convert's
              K1 and K2 calls against their plain versions on 2 frames (K1
              f32 within 2e-5, K2 within 2e-4), >= 55 dB; ms/frame.
 29. c7p      make_serving_fn of c7's source with HDR10+ metadata (one
              window with a guided curve: knee (0.25, 0.3), anchors 0.4,
              0.7, 0.9; selection 7): two scenes of 16 frames, each its
              runtime_hdr_from_hdr10plus values (scene peaks 4000 and
              2500 nits), K1 x2 + K2 x1 a call and nothing else, no build
              or library load between scenes, K2 on its runtime route;
              both scenes >= 55 dB against oracle_c7 with the window; the
              path's K1 and K2 calls on 2 frames against their plain
              versions (K1 mid16 within 1 code, K2 within 1 code on < 2%),
              K2's long-window route forced on the same call bit-equal;
              ms/frame, K2's time (runtime and forced long-window routes),
              its plain version's and its bound at batch 16.
 30. c8x      make_serving_fn of c8's source with Dolby Vision extension
              blocks (L1 (62, 3079, 1229), L2 trims for 100-, 600- and
              1000-nit targets) -> 1080p RGB10 SDR: two scenes of 16
              frames, each its curves and runtime_trims_from_extensions
              trims for the 100-nit display, K1 x2 + K8 + K9 a call, no
              build between scenes, K9 on its runtime route (the trims on
              the PQ signal before PQ -> SDR); >= 55 dB against
              oracle_dovi with the trims; K8 (within 1e-5) and K9 (within
              1 code on < 2%) against their plain versions on 2 frames;
              ms/frame, K9's time, its plain version's and its bound.
 31. c8hdr    the same source to a 600-nit HDR display (1080p RGB10 PQ)
              with the local tone map (BT.2390 upgraded to ST 2094-10 by
              L1): two scenes of runtime_hdr_from_extensions values and
              trims, K1 x2 + K8 + K9 a call, K9 on its runtime route (the
              trims in nits, then ST 2094-10's general form); >= 55 dB
              against oracle_dovi's HDR output; the checks and numbers of
              phase 30.
 32. c5s      api.VideoRenderer(Settings(convert_to_sdr=True,
              upscaling=LANCZOS3), pack_surface=True) on c5's source with
              a subtitle provider serving bench_common's 800 x 96 bitmap at
              (560, 950) at every time: 16 frames pushed with times through
              process_frame, then flush; K7 x1 + K9 x1 a pushed frame and
              nothing else; every field bit-equal to DeinterlaceSession.push
              + ops.overlay.blend_in_rect_packed on the same frames; field 0
              of frame 0 >= 55 dB against oracle_deint + the float64 blend
              (oracle.blend_packed_codes); ms a field through the renderer
              (synced per frame; with the threaded subtitle queue, the
              render-on-demand one and no overlay), and bench's form
              (push_batch at batch 16 + the blend on each output) beside
              phase 14's c5.
 33. renderer the headline through the renderer, pack_surface=True: an SRT
              line (io.srt, TextSubtitleProvider), a 256 x 64 logo bitmap
              and the stats OSD; 16 frames, each bit-equal to
              VideoProcessor.process + the blends (the OSD panels the
              renderer drew), K1 x3 + K2 a frame; rotation 180 bit-equal to
              the rotated packed dwords + the blends; a changed upscaler
              rebuilds once and the way back hits the cache; the BGR48
              displayed image and the source-sized current image; ms a
              frame, synced, with the overlays and without, and the stats
              panel's host rasterisation (the digest leaves the panel's
              rect out: it shows this run's timings).
 34. ingest   VideoProcessor.process_packed of 16 frames of 4K P010 bytes
              and of 4K v210 dwords -> 1080p RGB10: K1 x3 + K2 a call,
              bit-equal to process(unpack_frame(...).planes) on the card;
              ms a frame with the host->device copy, packed and planar, and
              the host unpack's.
 35. clip     runner.run_clip of the headline over 4 host (numpy) batches of
              16 (pinned staging buffers, a side copy stream): K1 x3 + K2 a
              batch, each output bit-equal to VideoProcessor.process of its
              batch; frames/s overlapped, and serial (put, compute, sync).
 36. c3sr     1080p NV12 -> 4K RGBA8 through VideoRenderer(vp_superres=P1080,
              pack_surface=True) with weights/superres_2x.npz, batch 8: the
              weights moved to the card once (the caller's model stays on
              the CPU), the gate engaged, the pipeline 1:1 on c1's route
              (K1 x2 + K2 a call, float output) then the net then the pack;
              the path's K1 and K2 calls on 2 frames against their plain
              versions; every output bit-equal to pack(net(pipeline));
              frame 0 >= 40 dB against the float64 oracle of the 1:1 plan
              then the same net (clamped, as the pack clamps), the pipeline
              alone >= 55 dB; a model left on the CPU raises on card
              input; ms/frame of the pipeline, the net and the pack (CUDA
              events) and of the renderer's call; the net's FLOPs and rate.
 37. c1vh     the same for 1080p NV12 SDR -> 1080p RGB10 PQ / BT.2020
              through VideoRenderer(vp_rtx_video_hdr=True) with an HDR
              output and weights/videohdr.npz, batch 32; the output signal
              info PQ / BT.2020.
 38. cli      videorenderer_tpu_torch.cli.main in this process: a .y4m clip
              of 8 1080p 4:2:0 frames -> 4K with --superres P1080 and the
              shipped weights and a BMP screenshot; 16 raw 4K P010 frames
              -> 1080p RGB10 with the headline's flags, --batch 16; 4 raw
              4K P010 HLG frames with --deinterlace double.  Each output
              file byte-equal to the renderer's output on the same frames
              through io.raw.RawVideoSink, the screenshot to its first
              frame; K1 x2 + K2, K1 x3 + K2, and K7 + K9 a frame; frames/s
              of each run (host clock, file IO included); ``cli info``
              names the card.
 39. train_sr sr_train.train of SuperResConfig() (128 channels, 4 blocks,
              s2d 4) from init_params(seed 0) at the command line's
              training defaults (256 synthetic frames, batch 16, patch 128,
              lr 1e-3): 3 steps twice on the card (bit-equal or not is
              recorded) and once on the CPU, within 1%; 40 steps, every
              loss finite, the mean of the last 8 below the first 8's;
              ms/step over steps 10-40 of that run (CUDA events around
              each of train's steps), the step's TFLOP/s (the forward,
              every weight gradient and every input gradient but the
              first conv's) and its bf16 bound; the
              parameters' digest, float32, and the held-out PSNR.
 40. train_hdr the same for hdr_train.train of VideoHDRConfig() (64
              channels, s2d 4); the held-out PQ PSNR against the base.
 41. train_dp make_mesh(device="cuda"): an NCCL group of one from a
              FileStore; 10 SuperRes steps with mesh= bit-equal to 10
              without (losses and parameters); the group destroyed.
 42. train_cli cli train-superres and train-videohdr (20 steps, 64 frames)
              with their JSON keys those of the JAX CLI, then cli process
              of phase 38's .y4m clip with each checkpoint (--superres
              P1080 to 4K; --videohdr-weights to RGB10 PQ): each file
              byte-equal to the renderer's with the checkpoint, the same
              K1 and K2 launches.
 43. c6       parallel/spatial's fused form of the headline's plan
              (build_plan("c6")), packed, batch 32, on a one-rank NCCL mesh
              (make_mesh(axis="spatial")): K1 x3 + K3 x3 a call, each call
              against its plain version (K1 mid16 within 1 code, K3 within
              2e-6), each K1 call's block rows and K3 call's route; the
              surface bit-equal to the same function without a mesh (a
              Shard(0, 1)), within 1 code on < 2% of the unsharded
              make_frame_fn's (K1 x3 + K2), >= 55 dB against the oracle;
              ms/frame beside make_frame_fn's.
 44. c6x4     the c6 plan as four shards run one after another on the card
              with no collective (spatial.drive_shards_locally: each
              shard's halos cut from the other shards' blocks, two passes):
              each shard's K3 on its own table, against its plain version
              on the same inputs (within 2e-6), its route and halo rows; the
              stitched surface bit-equal to phase 43's; an inner shard's
              three K3 calls timed with the plain version, the library call
              and the bound (K3's "per_shard" entry in the kernels line).
 45. c9       8K P010 PQ -> 4K RGB10 float (bench_common:229-236), batch 4:
              the checks and times of phase 43; the unsharded K2's route.
 46. spatial_dovi  c8's plan through the spatial Dolby Vision form (stage
              A: K1 on the chroma, K3 on its upsample, the reshape, matrix
              and LMS step in torch; stage B: K1 + K3 on the PQ RGB), batch
              16: K1 x3 + K3 x3 a call against their plain versions, within
              the JAX spatial DoVi band of the unsharded K1 x2 + K8 + K9
              surface (1.5/255, over 0.5/255 on < 1e-3 of the channels),
              >= 55 dB against oracle_dovi; ms/frame.
 47. spatial_sr  c3sr's plan (the 1:1 convert) and the shipped SuperRes
              through make_spatial_learned_fn, packed, batch 8: K1 x2 + K3
              x2 a call against their plain versions, >= 50 dB against the
              net on the unsharded frame function's output; ms/frame; then
              as four shards on the card (each shard's 40 halo rows zeroed
              outside the frame, row_valid, the s2d unit's pad 1080 -> 1088
              rows, the crop), the stitched surface bit-equal to the
              one-shard surface.
 48. spatial_c3  c3's plan (1080p NV12 -> 4K Jinc2, RGBA8) through the
              spatial Jinc2 form, batch 16: one K6 launch on each shard's
              band of rows (the frame's tap tables and weight table, the
              dither at the frame's rows), on the mesh and as four shards on
              the card (two passes), each surface bit-equal to the unsharded
              make_frame_fn's K6 call, >= 55 dB against oracle_jinc2;
              ms/frame beside make_frame_fn's.  Then c3 letterboxed into
              the 4K surface (J3_RECT), the form's K5 route: K1 x2 + K3 x2
              (stage A, the matrix in torch) + K5 on the band a call, each
              against its plain version (K5 within 1e-5); four shards
              bit-equal to one; within 1 code on < 2% of the unsharded K1 x2
              + K2 + K5 surface; the bars the packed zero; the rect >= 55 dB
              against oracle_jinc2; ms/frame beside make_frame_fn's.
 49. c2       VideoProcessor of 4K P010 -> 1080p RGB10, Catmull-Rom up and
              Hamming down (bench_common:171-176): two distinct batches of
              16, K1 x3 + K2 a call, the path's K1 and K2 calls on 2 frames
              against their plain versions, >= 55 dB; ms/frame.
 50. c4       the 4K tone map 1:1 to RGB8 (:200-204): K1 x2 + K2 a call
              (K2 reads the luma directly), the same checks.
 51. c8_two_stage  c8 with VRT_TPU_DOVI_MID=0 (set in the phase, restored
              after it): the two-stage Dolby Vision form, K1 x2 + K2's
              Dolby Vision route (stage A: the H upsample and the convert
              at source resolution, float32 PQ RGB) + K1 x3 + K2 (stage B)
              a call, on c8's four scenes, the variant (stage A's LMS
              route), c8x (stage B on K2's extended runtime route) and c8
              in C8_RECT (K2's offset store): each call's kernels on 2
              frames against their plain versions (stage A within 1e-5,
              the variant 1e-4; K1 float32 within 2e-5; K2 within 1 code
              on < 2%), the launch counts, no build between scenes,
              >= 55 dB against oracle_dovi; against the one-intermediate
              chain's surface (the switch at "1", the same function):
              differing on < 2% of the channels, over 1 code on < 1e-5
              of them and only near black (both codes under 32, where the
              SDR gamma amplifies a rounding step of the PQ sums); the
              bars the packed zero; ms/frame of both
              forms, stage A's time at batch 16 beside its byte bound and
              (c8) its plain version's.
Then the kernels' JSON line (each kernel's launches on the main paths, its
error against its plain version, its time, the plain version's, the bound
from this run's bytes and FLOPs, and the library call's time where one
PyTorch call computes the same function; K10's top-level numbers are its
wpass_bf16 form's, and "forms" holds both; K5's "k5_route" and
"table_launches" its route at c3r270 and the table launches of that path's
first call; K6's "table" holds the weight table kernel, whose launches are
the first calls of c3, c3rot and c3r270; K2's and K9's "runtime_route" their
runtime routes' numbers at c7p, c8x and c8hdr; K2's "dovi_route" its Dolby
Vision route at c8, phase 51), nvidia-smi's line, and last the result
line.
Any failure raises and the exit code is not 0.  Imports nothing of JAX.
Trees from before the weight tables run this script too, so that
smoke_diff.py compares the two: without K6's tables (TABLES) every output
computes its weights and the table checks are left out; without K5's
(K5_ROUTES) K5 builds no table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videorenderer_tpu_torch import (ColorFormat,  # noqa: E402
                                     DeinterlaceSession, OutputDescriptor,
                                     Settings, SourceDescriptor,
                                     VideoProcessor)
from videorenderer_tpu_torch.config import (ChromaScaling,  # noqa: E402
                                            Downscaling, SuperResolution,
                                            TexFormat, ToneMapType, Upscaling)
from videorenderer_tpu_torch.csputils import (CSP, ChromaLocation,  # noqa: E402
                                              Levels, Primaries, TRC)
from videorenderer_tpu_torch.kernels import build  # noqa: E402
from videorenderer_tpu_torch.kernels import deint as dk  # noqa: E402
from videorenderer_tpu_torch.kernels import jinc2 as jk  # noqa: E402
from videorenderer_tpu_torch.kernels import probe as pk  # noqa: E402
from videorenderer_tpu_torch.kernels import resize as rk  # noqa: E402
from videorenderer_tpu_torch.oracle import (oracle, oracle_c7,  # noqa: E402
                                            oracle_deint, oracle_dovi,
                                            oracle_gray, oracle_jinc2)
from videorenderer_tpu_torch.ops import (chroma, dovi, dovi_ext,  # noqa: E402
                                         hdr10plus, scale)
from videorenderer_tpu_torch.ops.tonemap import TRIM_KEYS  # noqa: E402
from videorenderer_tpu_torch import formats  # noqa: E402
from videorenderer_tpu_torch.api import VideoRenderer  # noqa: E402
from videorenderer_tpu_torch.io.srt import parse_srt  # noqa: E402
from videorenderer_tpu_torch.oracle import blend_packed_codes  # noqa: E402
from videorenderer_tpu_torch.ops.geometry import rotate_flip  # noqa: E402
from videorenderer_tpu_torch.ops.overlay import blend_in_rect_packed  # noqa: E402
from videorenderer_tpu_torch.runner import run_clip  # noqa: E402
from videorenderer_tpu_torch.cli import main as cli_main  # noqa: E402
from videorenderer_tpu_torch.io.raw import RawVideoSink  # noqa: E402
from videorenderer_tpu_torch.io.y4m import write_y4m  # noqa: E402
from videorenderer_tpu_torch.models import hdr_train, optim  # noqa: E402
from videorenderer_tpu_torch.models import real_eval  # noqa: E402
from videorenderer_tpu_torch.models import sr_train  # noqa: E402
from videorenderer_tpu_torch.models import superres as sr_model  # noqa: E402
from videorenderer_tpu_torch.models import videohdr as vh_model  # noqa: E402
from videorenderer_tpu_torch.models.checkpoint import load_params  # noqa: E402
from videorenderer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from videorenderer_tpu_torch.parallel import spatial as sp  # noqa: E402
from videorenderer_tpu_torch.subtitles import (SubPic,  # noqa: E402
                                               TextSubtitleProvider)
from videorenderer_tpu_torch.pipeline import (HDR10Metadata,  # noqa: E402
                                              _make_tail_epilogue,
                                              cmat_epilogue, fused_maps,
                                              make_deint_frame_fn,
                                              make_frame_fn, make_serving_fn,
                                              plan_pipeline)

DEVICE = "cuda"
W, H, OW, OH = 3840, 2160, 1920, 1080     # the headline: 4K -> 1080p
C1_W, C1_H = 1920, 1080                   # c1: 1080p 1:1
C3_OW, C3_OH = 3840, 2160                 # c3: 1080p -> 4K Jinc2
PLAIN_FRAMES = 2                          # frames of the Jinc2 plain runs
BATCH = 16
SEED = 0
LB_H = 1608                               # a 2.39:1 scope film, 3840 wide
LB_RECT = (0, 138, 1920, 942)             # ... letterboxed into 1920 x 1080
PILLAR_W = 2880                           # a 4:3 film, 2160 high ...
PILLAR_RECT = (240, 0, 1680, 1080)        # ... pillarboxed into 1920 x 1080
ODD_RECT = (2, 1, 1918, 1079)             # a column offset not a multiple of 4
THUMB_W, THUMB_H = 160, 90                # a 4K thumbnail
K4_TILES = (32, 24, 16, 8)                # phase 19: K4's tile rows timed
SMALL_W, SMALL_H = 320, 180               # a 4K preview
C8_RECT = (320, 180, 1600, 900)           # c8 into a rect of the 1080p surface
C8_SCENES = 4
C7_SCENES = 4
HDR_SCENES = 2                            # scenes of each of phases 29-31
# c5s's subtitle band: 800 x 96 at (560, 950) (bench_common.py:30)
SUB_W, SUB_H, SUB_X, SUB_Y = 800, 96, 560, 950
# phase 33's overlays on the headline: an SRT line, a logo, the stats OSD
SRT_XY = (480, 880)
LOGO_W, LOGO_H, LOGO_XY = 256, 64, (1600, 40)
SRT_TEXT = """1
00:00:00,000 --> 00:01:00,000
<i>The port draws this line</i>
on the packed backbuffer
"""
CLIP_BATCHES = 4                          # phase 35: host batches of BATCH
SR_BATCH, VH_BATCH = 8, 32                # c3sr, c1vh (bench_common.py:242)
CLI_SR_FRAMES = 8                         # phase 38's three runs
CLI_HEAD_FRAMES = 16
CLI_DEINT_FRAMES = 4
# phases 39-42: the full-width models at the command line's training
# defaults (cli.py's train parsers: batch 16, patch 128, 256 frames, lr 1e-3)
SR_TRAIN_CFG = sr_model.SuperResConfig()
VH_TRAIN_CFG = vh_model.VideoHDRConfig()
TRAIN_BATCH, TRAIN_PATCH, TRAIN_FRAMES, TRAIN_LR = 16, 128, 256, 1e-3
TRAIN_STEPS, TRAIN_TIMED_FROM = 40, 10    # ms/step over steps 10-40
TRAIN_CPU_STEPS = 3                       # the card's first steps vs the CPU's
TRAIN_VAL_FRAMES = 16
DP_STEPS = 10
CLI_TRAIN_STEPS, CLI_TRAIN_FRAMES = 20, 64
# the card's peaks for bound_ms (H100 SXM at 700 W): device memory, and
# float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12      # dense bf16 in the tensor cores (K10's products)
# K6 reads its weights from per-geometry tables (a tree without them
# computes every output's weights and has no table kernel); K5 shares them
# and has routes (a tree without K5_ROUTES: K5 computes every output's
# weights)
TABLES = hasattr(jk, "jinc2_weight_table")
K5_ROUTES = hasattr(jk, "k5_route")
# K4 has routes (a tree without them: one kernel, 32-row tiles, which
# refuses the thumbnail's windows)
K4_ROUTES = hasattr(rk, "k4_route")
C3R270_PLANES = 3 * BATCH                 # K5's planes at c3r270's batch
# phases 43-50: parallel/spatial (c6, c9, four shards of c6 on one card, the
# Dolby Vision, learned and Jinc2 forms) and c2, c4
C6_BATCH = 32                             # input_spec("c6"), bench_common:264
C9_W, C9_H, C9_OW, C9_OH = 7680, 4320, 3840, 2160   # c9: 8K -> 4K
C9_BATCH = 4                              # input_spec("c9"), bench_common:277
SHARDS = 4                                # phase 44: shards run on one card
J3_RECT = (0, 140, 3840, 2020)            # phase 48: c3 letterboxed, K5 route


def line(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of one ``fn()`` call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def p010_batch(batch: int, seed: int, dev, h: int | None = None):
    """TV-range 10-bit codes, MSB-aligned in uint16 (bench.py's frames), W
    wide and H rows unless ``h`` says otherwise."""
    return p010_frames(batch, seed, dev, W, H if h is None else h)


def p010_frames(batch: int, seed: int, dev, w: int, h: int):
    """p010_batch's frames at any width and height: the y, u and v codes
    drawn in that order from one seeded generator."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(64, 941, (batch, h, w), dtype=np.uint16) << 6,
        *(rng.integers(64, 961, (batch, h // 2, w // 2), dtype=np.uint16)
          << 6 for _ in range(2))))


def digest(*ts) -> str:
    """SHA-256 of the tensors' bytes, in order: two runs on the same seeded
    inputs print the same digest exactly when the outputs are bit-equal."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def tbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mbytes(*mats) -> int:
    """Bytes of the tap tables a kernel reads."""
    return sum(m.starts.nbytes + m.taps.nbytes for m in mats if m is not None)


def map_flops(mat, lines: int) -> int:
    """FLOPs of one axis map over ``lines`` rows (W) or columns (H): an FMA
    for every nonzero weight of every line."""
    return 0 if mat is None else 2 * lines * int(np.count_nonzero(mat.dense))


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_FP32_S) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the FLOPs over the rate of their type (float32
    unless ``peak_flops`` says otherwise)."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak_flops
    return {"bound_ms": 1e3 * max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def dovi_meta():
    """c8's RPU metadata (bench_common.dovi_meta): identity curves, the
    BT.2020 ycc_to_rgb matrix, LMS matrices that are mutual inverses."""
    return dovi.DoviMetadata(
        curves=(dovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi.DOVI_LMS2RGB))


def dovi_variant():
    """c8's metadata where nothing folds: a 2-piece polynomial on Y, a
    polynomial + MMR order-2 curve on Cb, an MMR order-3 curve on Cr, and
    an LMS product with 2% crosstalk."""
    base = dovi_meta()
    cb = np.zeros((2, 3, 7))
    cb[1, 0] = [0, 0.98, 0, 0.02, 0, -0.01, 0]
    cb[1, 1] = [0, 0.01, 0, 0, 0.005, 0, 0.01]
    cr = np.zeros((1, 3, 7))
    cr[0, 0] = [0, 0, 0.97, 0, 0.02, 0.01, 0]
    cr[0, 1] = [0, 0, 0.02, 0.01, 0, 0, 0]
    cr[0, 2] = [0, 0, 0.005, 0, 0, 0, 0.003]
    curves = (
        dovi.ReshapeCurve(pivots=(0.45,), method=(0, 0),
                          poly=np.array([[0.01, 0.95, 0.05],
                                         [-0.02, 1.05, -0.03]])),
        dovi.ReshapeCurve(pivots=(0.5,), method=(0, 1),
                          poly=np.array([[0, 1.0, 0], [0, 0, 0]]),
                          mmr_order=(0, 2), mmr_constant=(0.0, 0.01),
                          mmr_coef=cb),
        dovi.ReshapeCurve(pivots=(), method=(1,), poly=np.array([[0, 1.0, 0]]),
                          mmr_order=(3,), mmr_constant=(-0.005,), mmr_coef=cr))
    return dovi.DoviMetadata(
        curves=curves, ycc_to_rgb_matrix=base.ycc_to_rgb_matrix,
        ycc_to_rgb_offset=base.ycc_to_rgb_offset,
        rgb_to_lms_matrix=base.rgb_to_lms_matrix @ (0.94 * np.eye(3) + 0.02))


def dovi_rt(i: int, meta=None) -> dict:
    """Scene i's curves (bench_common.dovi_rt): every packed array times
    (1 - 0.01 i), float32 host arrays."""
    return {k: v * np.float32(1.0 - 0.01 * i) for k, v in
            dovi.pack_curves(meta or dovi_meta()).items()}


def c8_args(meta, accel: bool = True):
    """c8 (bench_common.build_plan("c8")): 4K P010 Dolby Vision, PQ,
    BT.2020 NCL, TV -> 1080p RGB10, Catmull-Rom (2:1 on both axes, the
    interpolating filter under the 50% rule), DoVi -> SDR, 10-bit dither."""
    return (Settings(convert_to_sdr=True, upscaling=Upscaling.CATMULL_ROM,
                     use_accel_backend=accel),
            SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                             matrix=CSP.BT_2020_NC, levels=Levels.TV,
                             primaries=Primaries.BT_2020, transfer=TRC.PQ,
                             dovi=meta, hdr10=HDR10Metadata()),
            OutputDescriptor(width=OW, height=OH, bits=10))


def c8_oracle(planes, meta, curves):
    """oracle_dovi on frame 0 of a batch, with a scene's curves."""
    return oracle_dovi(*(p[0] for p in planes), OW, OH, curves=curves,
                       structure=dovi.curve_structure(meta),
                       ycc_to_rgb=meta.ycc_to_rgb_matrix,
                       ycc_offset=meta.ycc_to_rgb_offset,
                       lms=dovi.lms_pipeline_matrix(meta))


def codes(dwords: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., H, W) packed dwords -> (..., 3, H, W) int32 channel codes."""
    mask = (1 << bits) - 1
    return torch.stack([(dwords >> (bits * i)) & mask for i in range(3)], -3)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def nv12_batch(batch: int, seed: int, dev):
    """TV-range 8-bit 1080p NV12 planes (c1, c3)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(p).to(dev) for p in (
        rng.integers(16, 236, (batch, C1_H, C1_W), dtype=np.uint8),
        rng.integers(16, 241, (batch, C1_H // 2, C1_W // 2), dtype=np.uint8),
        rng.integers(16, 241, (batch, C1_H // 2, C1_W // 2), dtype=np.uint8)))


def c3_args(rotated: bool = False):
    """c3 (bench_common.build_plan("c3")): 1080p NV12 BT.709 TV, Jinc2 to
    4K, ordered dither to 8 bits, bilinear chroma.  ``rotated``: the c3rot
    plan, a 2160-wide x 3840-high output (bench_configs.py:204-210)."""
    ow, oh = (C3_OH, C3_OW) if rotated else (C3_OW, C3_OH)
    return (Settings(upscaling=Upscaling.JINC2, use_dither=True,
                     chroma_scaling=ChromaScaling.BILINEAR),
            SourceDescriptor(format=ColorFormat.NV12, width=C1_W, height=C1_H,
                             matrix=CSP.BT_709, levels=Levels.TV),
            OutputDescriptor(width=ow, height=oh, bits=8))


def count_launches(fn):
    """Run ``fn`` with every launch count at 0 first; returns its result
    and the counts it made."""
    torch.cuda.synchronize()
    rk.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(rk.launches)


@contextlib.contextmanager
def recording(module, *names):
    """Wrap the kernel wrappers ``module.<name>`` so that every call made
    inside the block is kept as (args, kwargs, result), the result being
    the kernel's own output; the wrappers are restored after the block."""
    calls = {n: [] for n in names}
    originals = {n: getattr(module, n) for n in names}

    def keep(n):
        def call(*args, **kwargs):
            out = originals[n](*args, **kwargs)
            calls[n].append((args, kwargs, out))
            return out
        return call

    for n in names:
        setattr(module, n, keep(n))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)


def only(**counts) -> dict:
    """The launch counts of a call that launches these kernels and no
    other."""
    return {k: counts.get(k, 0) for k in rk.launches}


def code_diff(a: torch.Tensor, b: torch.Tensor, bits: int) -> dict:
    d = (codes(a, bits) - codes(b, bits)).abs()
    return {"max_code_diff": int(d.max().item()),
            "frac_differing": float((d > 0).double().mean().item())}


def placed_check(outs, batches, rect, unplaced) -> dict:
    """A placed path's outputs (..., OH, OW dwords) against the same inputs
    through the unplaced plan of the rect's size (``unplaced(batch)``): the
    rect bit-equal to its surface (the same maps, the dither from the
    video's origin), every dword outside the rect the packed zero."""
    l, tp, r, bt = rect
    mask = torch.ones((OH, OW), dtype=torch.bool, device=outs[0].device)
    mask[tp:bt, l:r] = False
    out = {"rect": list(rect), "bars_black": True, "rect_bit_equal": True}
    for o, b in zip(outs, batches):
        if o.shape[-2:] != (OH, OW) or o.dtype != torch.int32:
            raise AssertionError(f"placed output {tuple(o.shape)} {o.dtype}")
        out["bars_black"] &= bool(torch.all(
            o[..., mask] == rk.PACKED_ZERO["rgb10a2"]).item())
        out["rect_bit_equal"] &= bool(torch.equal(o[..., tp:bt, l:r],
                                                  unplaced(b)))
    return out


def headline_args():
    src = SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                           matrix=CSP.BT_2020_NC, levels=Levels.TV,
                           primaries=Primaries.BT_2020, transfer=TRC.PQ,
                           hdr10=HDR10Metadata())
    dst = OutputDescriptor(width=OW, height=OH, bits=10)
    return src, dst


def c5_args(accel: bool = True):
    """c5 (bench_common.build_plan("c5")): 4K P010 HLG, BT.2020 NCL, TV
    range, interlaced top field first -> 1080p, Lanczos3 (2:1 on both axes,
    the interpolating filter under the 50% rule), HLG -> SDR, 8-bit ordered
    dither."""
    return (Settings(convert_to_sdr=True, upscaling=Upscaling.LANCZOS3,
                     use_accel_backend=accel),
            SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                             matrix=CSP.BT_2020_NC, levels=Levels.TV,
                             primaries=Primaries.BT_2020, transfer=TRC.HLG,
                             interlaced=True),
            OutputDescriptor(width=OW, height=OH, bits=8))


def c7_args(accel: bool = True, tex_format: TexFormat = TexFormat.AUTOINT):
    """c7 (bench_common.build_plan("c7")): 4K P010 HDR10 (mastering 4000
    nits, MaxCLL 3000, MaxFALL 800) -> 4K R10G10B10A2 PQ for a 600-nit
    display, the BT.2390 local tone map."""
    return (Settings(convert_to_sdr=False, hdr_passthrough=True,
                     hdr_local_tone_mapping=True,
                     hdr_local_tone_mapping_type=ToneMapType.BT2390,
                     hdr_display_max_nits=600, use_accel_backend=accel,
                     tex_format=tex_format),
            SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                             matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                             transfer=TRC.PQ,
                             hdr10=HDR10Metadata(mastering_max_nits=4000.0,
                                                 max_cll=3000.0,
                                                 max_fall=800.0)),
            OutputDescriptor(width=W, height=H, bits=10, hdr=True))


def c7_rt(i: int) -> dict:
    """Scene i's HDR10 values (bench_common.c7_rt): MaxCLL 1200 + 100 i
    nits for a 650-nit display."""
    return {"hdr": {"mastering_min_nits": 0.005, "mastering_max_nits": 2000.0,
                    "max_cll": 1200.0 + 100.0 * i, "max_fall": 450.0,
                    "display_max_nits": 650.0}}


def c7_oracle(planes, hdr: dict) -> torch.Tensor:
    """oracle_c7 on frame 0 of a batch with a scene's HDR10 values."""
    return oracle_c7(*(p[0] for p in planes), max_cll=hdr["max_cll"],
                     display_max_nits=hdr["display_max_nits"],
                     mastering_max_nits=hdr["mastering_max_nits"])


def float_code_diff(a: torch.Tensor, b: torch.Tensor, levels: int) -> dict:
    """Code differences of two dithered float outputs (codes / levels)."""
    d = ((a - b).abs() * levels).round()
    return {"max_code_diff": int(d.max().item()),
            "frac_differing": float((d > 0).double().mean().item())}


def headline_settings(accel: bool, tex_format: TexFormat = TexFormat.AUTOINT
                      ) -> Settings:
    return Settings(upscaling=Upscaling.LANCZOS3,
                    chroma_scaling=ChromaScaling.BILINEAR,
                    convert_to_sdr=True, use_dither=True,
                    use_accel_backend=accel, tex_format=tex_format)


def fresh_tables() -> None:
    """Drop the cached weight tables, so that a path's next call builds
    its own."""
    if TABLES:
        jk.clear_weight_tables()


@contextlib.contextmanager
def per_output_weights():
    """K5 and K6 with the table cap at 0: every geometry takes the
    per-output route (the cap is K6_TABLE_CAP on trees from before K5's
    tables)."""
    if not TABLES:
        yield
        return
    cap_name = "TABLE_CAP" if hasattr(jk, "TABLE_CAP") else "K6_TABLE_CAP"
    cap = getattr(jk, cap_name)
    setattr(jk, cap_name, 0)
    try:
        yield
    finally:
        setattr(jk, cap_name, cap)


def k5_route(h: int, w: int, out_h: int, out_w: int) -> str:
    """K5's route at a geometry ("weights/taps"), or "per-output" on a tree
    whose K5 has one route."""
    if not K5_ROUTES:
        return "per-output"
    return "/".join(jk.k5_route(h, w, out_h, out_w))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def forced_long(module, flag: str, fn):
    """``fn()`` with the long-window route flag ``module.<flag>`` on."""
    setattr(module, flag, True)
    try:
        return fn()
    finally:
        setattr(module, flag, False)


def one_call(module, name: str, fn):
    """Run ``fn`` recording the wrapper ``module.<name>``: its one call's
    (args, kwargs, output)."""
    with recording(module, name) as calls:
        fn()
    torch.cuda.synchronize()
    if len(calls[name]) != 1:
        raise AssertionError(f"{name} was called {len(calls[name])} times")
    return calls[name][0]


def k4_timed(fn) -> float:
    """ms of one K4 call ``fn()`` (CUDA events), after checking that such a
    call launches K4 once and no other kernel."""
    _, n = count_launches(fn)
    if n != only(mega3_tail=1):
        raise AssertionError(f"a K4 call launched {n}")
    return cuda_ms(fn)


def k4_tiles(fn, frames, sizes, maps):
    """K4's staged route at each tile height of K4_TILES whose layout fits
    shared memory (rk.k4_route replaced for the call): ms of ``fn(None)``
    at each (k4_timed), and whether ``fn(frames)`` is bit-equal across them
    (the tile changes no FMA)."""
    chosen, ms, outs = rk.k4_route, {}, []
    try:
        for rows in K4_TILES:
            if rk.k4_smem_bytes(*sizes, *maps, rows) > rk.SMEM_BUDGET:
                continue
            rk.k4_route = lambda *a, _rows=rows: ("staged", _rows, 0)
            ms[str(rows)] = k4_timed(lambda: fn(None))
            outs.append(fn(frames))
    finally:
        rk.k4_route = chosen
    torch.cuda.synchronize()
    return ms, all(torch.equal(outs[0], o) for o in outs[1:])


def thumb_k4_args(tex_format: TexFormat = TexFormat.AUTOINT):
    """The headline source -> a 160 x 90 RGB10 thumbnail, Lanczos: K4's
    long-window route (its windows do not fit shared memory)."""
    return (Settings(downscaling=Downscaling.LANCZOS,
                     chroma_scaling=ChromaScaling.BILINEAR,
                     convert_to_sdr=True, use_dither=True,
                     tex_format=tex_format),
            headline_args()[0],
            OutputDescriptor(width=THUMB_W, height=THUMB_H, bits=10))


def timed_calls(fn, batches) -> float:
    """ms a frame of ``fn`` over the batches, back to back (CUDA events)."""
    return cuda_ms(lambda: [fn(b) for b in batches], reps=1, warmup=0) / (
        len(batches) * BATCH)


def guided_meta(peak: float = 0.4):
    """c7p's HDR10+ metadata (tests/test_hdr10plus.py:107-111): one window
    with a guided curve, knee (0.25, 0.3), anchors 0.4, 0.7 and 0.9,
    maxscl ``peak`` of 10 000 nits (0.4: a 4000-nit scene)."""
    return hdr10plus.HDR10PlusMetadata(windows=(hdr10plus.HDR10PlusWindow(
        maxscl=(peak, peak, peak), average_maxrgb=0.05, tone_mapping_flag=1,
        knee_point_x=0.25, knee_point_y=0.3,
        bezier_curve_anchors=(0.4, 0.7, 0.9)),))


def dovi_extensions(i: int = 0):
    """Scene i's Dolby Vision extension blocks (tests/test_dovi_ext.py:
    L1 (62, 3079, 1229), L2 trims for 100-, 600- and 1000-nit targets):
    the scene moves L1's peak down by 120 i and the 100-nit trim's slope
    up by 200 i."""
    def l2(nits, **kw):
        return dovi_ext.L2Extension(
            target_max_pq=int(round(dovi_ext.nits_to_pq(nits) * 4095)), **kw)
    return dovi_ext.DoviExtensions(
        l1=dovi_ext.L1Extension(min_pq=62, max_pq=3079 - 120 * i,
                                avg_pq=1229),
        l2=(l2(100, trim_slope=1800 + 200 * i, trim_offset=2100,
               trim_power=2200, trim_chroma_weight=2148,
               trim_saturation_gain=2348),
            l2(600, trim_slope=2000, trim_power=1900,
               trim_saturation_gain=2148),
            l2(1000, trim_slope=2200)))


def c7p_args(accel: bool = True):
    """c7p: c7's source and display with HDR10+ metadata whose window
    carries a guided curve: selection 7."""
    s, src, dst = c7_args(accel)
    return s, dataclasses.replace(src, hdr10plus=guided_meta()), dst


def c8ext_args(hdr: bool, accel: bool = True):
    """c8's source and RPU metadata with extension blocks: c8x to 1080p
    RGB10 SDR (the trims selected for the 100-nit SDR display), or c8hdr
    to a 600-nit HDR display at 1080p RGB10 PQ with the local tone map
    (BT.2390, upgraded to ST 2094-10 by L1)."""
    s, src, dst = c8_args(dovi_meta(), accel)
    src = dataclasses.replace(src, dovi_ext=dovi_extensions())
    if not hdr:
        return dataclasses.replace(s, hdr_display_max_nits=100), src, dst
    return (Settings(convert_to_sdr=False, hdr_passthrough=True,
                     hdr_local_tone_mapping=True,
                     hdr_local_tone_mapping_type=ToneMapType.BT2390,
                     hdr_display_max_nits=600,
                     upscaling=Upscaling.CATMULL_ROM,
                     use_accel_backend=accel),
            src, dataclasses.replace(dst, hdr=True))


def trim_list(rt: dict) -> list:
    """A serving call's "l2_trims" values in the oracle's order."""
    return [float(rt["l2_trims"][k]) for k in TRIM_KEYS]


def serve_counted(serve, batches, rts, expect: dict):
    """Each batch through ``serve`` with its scene's values, counted from 0:
    the launches must be ``expect`` and no scene may build or load the
    kernels.  Returns the outputs, the counts and each call's ms (CUDA
    events)."""
    lib_before, builds, times = build.load(), [], []
    real_build = build.build
    build.build = lambda: builds.append(1) or real_build()

    def run():
        outs = []
        for b, rt in zip(batches, rts):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(serve(b, rt))
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        return outs

    try:
        outs, n = count_launches(run)
    finally:
        build.build = real_build
    if n != expect:
        raise AssertionError(f"launches {n}, expected {expect}")
    if builds or build.load() is not lib_before:
        raise AssertionError("a scene change built or loaded the kernels")
    return outs, n, times


def hdr_dynamic_phases(dev) -> dict:
    """Phases 29-31: HDR10+ with its guided curve (c7p, K2's runtime route,
    and K2's long-window route forced on it) and the Dolby Vision extension
    blocks with their L2 trims (c8x to SDR, c8hdr to an HDR display, K9's
    runtime route), each served over HDR_SCENES scenes of batch 16 at full
    4K source width.  Returns each phase's launches, the kernels' errors
    against their plain versions and K2's and K9's runtime-route numbers
    for the kernels line."""
    res = {"launches": {}, "runtime": {"rows3_tail": {}, "cols3_tail": {}},
           "err": {k: 0.0 for k in ("k1", "k2", "k8", "k9")}}

    def err(k, x):
        res["err"][k] = max(res["err"][k], float(x))

    # 29. c7p: make_serving_fn of c7's source with HDR10+ (selection 7),
    #     two scenes of runtime_hdr_from_hdr10plus values (the scene peak
    #     moves), K1 x2 + K2 x1 a call, K2 on its runtime route
    plan7 = plan_pipeline(*c7p_args())
    if plan7.tonemap_type != 7:
        raise AssertionError(f"c7p plans selection {plan7.tonemap_type}")
    serve7 = make_serving_fn(plan7, pack_surface=True)
    metas = [guided_meta(0.4 - 0.15 * i) for i in range(HDR_SCENES)]
    rts7 = [{"hdr": hdr10plus.runtime_hdr_from_hdr10plus(
        m, plan7.src.hdr10, 600.0)} for m in metas]
    b7 = [p010_batch(BATCH, SEED + 90 + i, dev) for i in range(HDR_SCENES)]
    with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
        serve7(tuple(p[:PLAIN_FRAMES] for p in b7[0]), rts7[1])
    torch.cuda.synchronize()
    k1_calls, k2_calls = calls["banded_resize_last_axis"], calls["rows3_tail"]
    if len(k1_calls) != 2 or len(k2_calls) != 1:
        raise AssertionError(f"c7p recorded {len(k1_calls)} K1 and "
                             f"{len(k2_calls)} K2 calls")
    k1d = max(int((got.float() - rk.banded_resize_last_axis_plain(
        *a, **kw).float()).abs().max().item()) for a, kw, got in k1_calls)
    (a2, kw2, got2), = k2_calls
    route7 = rk.rows3_tail_route(a2[0].dtype, a2[1].dtype, a2[6],
                                 kw2.get("pack_format"))
    d7 = code_diff(got2, rk.rows3_tail_plain(*a2, **kw2), 10)
    long7 = forced_long(rk, "K2_LONG_WINDOW", lambda: rk.rows3_tail(*a2,
                                                                    **kw2))
    torch.cuda.synchronize()
    long_equal = bool(torch.equal(long7, got2))
    k7_digest = digest(got2)
    tm7 = a2[6].tonemap
    err("k1", k1d)
    err("k2", d7["max_code_diff"] / 1023.0)
    del calls, k1_calls, k2_calls, a2, kw2, got2, long7
    if route7 != "runtime" or tm7 != 7 \
            or k1d > 1 or d7["max_code_diff"] > 1 \
            or d7["frac_differing"] >= 0.02 or not long_equal:
        raise AssertionError(f"c7p: K2 route {route7}, K1 {k1d}, K2 {d7}, "
                             f"long-window bit-equal {long_equal}")
    with recording(rk, "rows3_tail") as calls:       # also the warm-up
        serve7(b7[0], rts7[0])
    torch.cuda.synchronize()
    (a16, kw16, _), = calls["rows3_tail"]
    del calls
    outs7, n7, t7 = serve_counted(
        serve7, b7, rts7, only(banded_resize_last_axis=2 * HDR_SCENES,
                               rows3_tail=HDR_SCENES))
    res["launches"]["c7p"] = n7
    for o in outs7:
        if o.shape != (BATCH, H, W) or o.dtype != torch.int32:
            raise AssertionError(f"c7p output {tuple(o.shape)} {o.dtype}")
    db7 = {f"scene{i}": psnr(
        codes(outs7[i][0], 10).double() / 1023.0,
        oracle_c7(*(p[0] for p in b7[i]),
                  max_cll=float(rts7[i]["hdr"]["max_cll"]),
                  display_max_nits=float(rts7[i]["hdr"]["display_max_nits"]),
                  mastering_max_nits=float(
                      rts7[i]["hdr"]["mastering_max_nits"]),
                  window=metas[i].windows[0]))
        for i in range(HDR_SCENES)}
    digest7 = digest(*outs7)
    del outs7
    ms7 = cuda_ms(lambda: [serve7(b, rt) for b, rt in zip(b7, rts7)],
                  reps=1, warmup=0) / (HDR_SCENES * BATCH)
    k2r = {"cell": "c7p", "ms": cuda_ms(lambda: rk.rows3_tail(*a16, **kw16)),
           "long_window_ms": forced_long(
               rk, "K2_LONG_WINDOW",
               lambda: cuda_ms(lambda: rk.rows3_tail(*a16, **kw16))),
           "plain_ms": cuda_ms(lambda: rk.rows3_tail_plain(*a16, **kw16),
                               reps=1)}
    # K2 at c7p: raw luma, the mid16 chroma and the packed surface; the
    # chroma H taps and the matrix (not the tone map's pows and curve)
    k2r.update(bound(tbytes(*a16[:3]) + BATCH * H * W * 4 + mbytes(a16[4]),
                     2 * map_flops(a16[4], BATCH * W) + 18 * BATCH * H * W))
    res["runtime"]["rows3_tail"] = k2r
    del a16, kw16
    if min(db7.values()) < 55.0:
        raise AssertionError(f"c7p PSNR below 55 dB: {db7}")
    line("c7p", batch=BATCH, scenes=HDR_SCENES, launches=n7,
         builds_between_scenes=0, k2_route=route7, psnr_db=db7,
         ms_per_frame=ms7, ms_per_frame_synced=sum(t7) / (HDR_SCENES * BATCH),
         k2_ms=k2r["ms"], k2_long_window_ms=k2r["long_window_ms"],
         k2_plain_ms=k2r["plain_ms"], k2_bound_ms=k2r["bound_ms"],
         k2_bound_by=k2r["bound_by"], kernels_frames=PLAIN_FRAMES,
         k1_max_code_diff=k1d, k2_vs_plain=d7,
         k2_long_window_bit_equal=long_equal, k2_digest=k7_digest,
         digest=digest7,
         tolerance="K1 mid16 <= 1 code; K2 <= 1 code on < 2% of channels; "
                   "long-window K2 bit-equal")
    del b7, serve7
    torch.cuda.empty_cache()

    # 30-31. c8x and c8hdr: make_serving_fn of c8's source with extension
    #     blocks, two scenes of curves and trims (c8x) or HDR10 values and
    #     trims (c8hdr), K1 x2 + K8 + K9 a call, K9 on its runtime route
    meta = dovi_meta()
    structure = dovi.curve_structure(meta)
    exts = [dovi_extensions(i) for i in range(HDR_SCENES)]
    for name, hdr, seed in (("c8x", False, SEED + 92),
                            ("c8hdr", True, SEED + 94)):
        plan = plan_pipeline(*c8ext_args(hdr))
        serve = make_serving_fn(plan, pack_surface=True)
        display = 600.0 if hdr else 100.0
        rts = []
        for i, e in enumerate(exts):
            rt = {"l2_trims": dovi_ext.runtime_trims_from_extensions(
                e, display)}
            if hdr:
                rt["hdr"] = dovi_ext.runtime_hdr_from_extensions(
                    e, plan.src.hdr10, display)
            else:
                rt["dovi_curves"] = dovi_rt(i)
            rts.append(rt)
        bs = [p010_batch(BATCH, seed + i, dev) for i in range(HDR_SCENES)]
        with recording(dk, "rows3_mid", "cols3_tail") as calls:
            serve(tuple(p[:PLAIN_FRAMES] for p in bs[0]), rts[1])
        torch.cuda.synchronize()
        (a8, kw8, got8), = calls["rows3_mid"]
        (a9, kw9, got9), = calls["cols3_tail"]
        e8 = max((g - r).abs().max().item() for g, r in zip(
            got8, dk.rows3_mid_plain(*a8, **kw8)))
        route9 = dk.cols3_tail_route(a9[0].dtype, a9[1].dtype, a9[6],
                                     kw9.get("pack_format"))
        d9 = code_diff(got9, dk.cols3_tail_plain(*a9, **kw9), 10)
        if hdr != (a9[6].tonemap == 6) or a9[6].trims is None \
                or a9[6].trims_pq == hdr:
            raise AssertionError(f"{name}: K9 tone map {a9[6].tonemap}, "
                                 f"trims {a9[6].trims}")
        err("k8", e8)
        err("k9", d9["max_code_diff"] / 1023.0)
        k9_digest = digest(got9)
        del calls, a8, kw8, got8, a9, kw9, got9
        if route9 != "runtime" or e8 > 1e-5 or d9["max_code_diff"] > 1 \
                or d9["frac_differing"] >= 0.02:
            raise AssertionError(f"{name}: K9 route {route9}, K8 {e8}, K9 "
                                 f"{d9}")
        with recording(dk, "cols3_tail") as calls:   # also the warm-up
            serve(bs[0], rts[0])
        torch.cuda.synchronize()
        (a9, kw9, _), = calls["cols3_tail"]
        del calls
        outs, n, times = serve_counted(
            serve, bs, rts, only(banded_resize_last_axis=2 * HDR_SCENES,
                                 rows3_mid=HDR_SCENES,
                                 cols3_tail=HDR_SCENES))
        res["launches"][name] = n
        for o in outs:
            if o.shape != (BATCH, OH, OW) or o.dtype != torch.int32:
                raise AssertionError(f"{name} output {tuple(o.shape)} "
                                     f"{o.dtype}")

        def want(i):
            rt = rts[i]
            h = rt.get("hdr")
            return oracle_dovi(
                *(p[0] for p in bs[i]), OW, OH,
                curves=rt.get("dovi_curves") or dovi.pack_curves(meta),
                structure=structure, ycc_to_rgb=meta.ycc_to_rgb_matrix,
                ycc_offset=meta.ycc_to_rgb_offset,
                lms=dovi.lms_pipeline_matrix(meta), trims=trim_list(rt),
                hdr_out=None if h is None else {
                    k: float(h[k]) for k in ("mastering_min_nits",
                                             "max_cll", "max_fall",
                                             "display_max_nits")})

        db = {f"scene{i}": psnr(codes(outs[i][0], 10).double() / 1023.0,
                                want(i)) for i in range(HDR_SCENES)}
        out_digest = digest(*outs)
        del outs
        ms = cuda_ms(lambda: [serve(b, rt) for b, rt in zip(bs, rts)],
                     reps=1, warmup=0) / (HDR_SCENES * BATCH)
        k9r = {"ms": cuda_ms(lambda: dk.cols3_tail(*a9, **kw9)),
               "plain_ms": cuda_ms(lambda: dk.cols3_tail_plain(*a9, **kw9),
                                   reps=1)}
        # K9's bound as at c8 (phase 17): the three float32 mid planes in,
        # the RGB10 dwords out, the W map once; the W taps' FMAs
        rows9 = a9[0].numel() // a9[0].shape[-1]
        k9r.update(bound(tbytes(*a9[:3]) + rows9 * OW * 4 + mbytes(a9[3]),
                         3 * map_flops(a9[3], rows9)))
        res["runtime"]["cols3_tail"][name] = k9r
        del a9, kw9, bs, serve
        torch.cuda.empty_cache()
        if min(db.values()) < 55.0:
            raise AssertionError(f"{name} PSNR below 55 dB: {db}")
        line(name, batch=BATCH, scenes=HDR_SCENES, launches=n,
             builds_between_scenes=0, k9_route=route9,
             tonemap_type=plan.tonemap_type, psnr_db=db, ms_per_frame=ms,
             ms_per_frame_synced=sum(times) / (HDR_SCENES * BATCH),
             k9_ms=k9r["ms"], k9_plain_ms=k9r["plain_ms"],
             k9_bound_ms=k9r["bound_ms"], k9_bound_by=k9r["bound_by"],
             kernels_frames=PLAIN_FRAMES, k8_max_abs_err=e8, k9_vs_plain=d9,
             k9_digest=k9_digest, digest=out_digest,
             tolerance="K8 <= 1e-5; K9 <= 1 code on < 2% of channels")
    return res


def offset_tail_phases(dev) -> dict:
    """Phases 22-28: the strong downscales (the long-window routes of K2,
    K7, K8's staged tiles and K9), Dolby Vision in a rect (K9's offset
    store), the SDR BT.2020 fix in K2, a GRAY source (K1 + K3) and the
    shader order (K2's convert with the correction).  Returns each phase's
    launches, the kernels' errors against their plain versions and K3's
    numbers for the kernels line."""
    src, _ = headline_args()
    res = {"launches": {}, "err": {k: 0.0 for k in ("k1", "k2", "k7", "k8",
                                                    "k9")}}

    def err(k, x):
        res["err"][k] = max(res["err"][k], float(x))

    # 22. thumb: the headline source -> 160 x 90 RGB10 (Hamming, 24:1), two
    #     distinct batches, K1 x3 + K2 x1 a call, K2 on its long-window
    #     route; K2's long-window route forced on the headline's own
    #     shapes (2 frames) bit-equal to the staged route
    dst_t = OutputDescriptor(width=THUMB_W, height=THUMB_H, bits=10)
    vp_t = VideoProcessor(headline_settings(True), src, dst_t, device=dev,
                          pack_surface=True)
    tb = [p010_batch(BATCH, SEED + 70 + i, dev) for i in range(2)]
    a2, kw2, got2 = one_call(rk, "rows3_tail", lambda: vp_t.process(tb[0]))
    route = rk.k2_route(a2[0].element_size(), a2[1].element_size(), a2[3],
                        a2[4])
    d = code_diff(got2, rk.rows3_tail_plain(*a2, **kw2), 10)
    err("k2", d["max_code_diff"] / 1023.0)
    k2_thumb_ms = cuda_ms(lambda: rk.rows3_tail(*a2, **kw2))
    del a2, kw2, got2
    outs, n_t = count_launches(lambda: [vp_t.process(b) for b in tb])
    res["launches"]["thumb"] = n_t
    if n_t != only(banded_resize_last_axis=6, rows3_tail=2) \
            or route != "long-window" or d["max_code_diff"] > 1 \
            or d["frac_differing"] >= 0.02:
        raise AssertionError(f"thumb: launches {n_t}, K2 route {route}, "
                             f"K2 against its plain version {d}")
    db_t = psnr(codes(outs[0][0], 10).double() / 1023.0,
                oracle(*(p[0] for p in tb[0]), THUMB_W, THUMB_H))
    thumb_digest = digest(*outs)
    del outs
    ms_t = timed_calls(vp_t.process, tb)
    two = tuple(p[:PLAIN_FRAMES] for p in tb[0])
    vp_h = VideoProcessor(headline_settings(True), src, OutputDescriptor(
        width=OW, height=OH, bits=10), device=dev, pack_surface=True)
    a2, kw2, staged = one_call(rk, "rows3_tail", lambda: vp_h.process(two))
    long2 = forced_long(rk, "K2_LONG_WINDOW", lambda: rk.rows3_tail(*a2,
                                                                    **kw2))
    torch.cuda.synchronize()
    k2_bit_equal = bool(torch.equal(long2, staged))
    k2_headline = {"staged_ms": cuda_ms(lambda: rk.rows3_tail(*a2, **kw2)),
                   "long_window_ms": forced_long(
                       rk, "K2_LONG_WINDOW",
                       lambda: cuda_ms(lambda: rk.rows3_tail(*a2, **kw2)))}
    del a2, kw2, staged, long2, tb, two, vp_h
    if db_t < 55.0 or not k2_bit_equal:
        raise AssertionError(f"thumb: PSNR {db_t}, K2 long-window route "
                             f"bit-equal {k2_bit_equal}")
    line("thumb", batch=BATCH, size=[THUMB_W, THUMB_H], launches=n_t,
         k2_route=route, psnr_db=db_t, ms_per_frame=ms_t,
         k2_ms=k2_thumb_ms, k2_vs_plain=d, digest=thumb_digest,
         k2_long_window_bit_equal_headline=k2_bit_equal,
         k2_headline_frames=PLAIN_FRAMES, k2_headline=k2_headline)

    # 23. c5 small: DeinterlaceSession(double_rate=True) on c5's source ->
    #     320 x 180 RGBA8, K7 + K9 a step, K7 on its long-window route (K9
    #     on the route its spans pick, its long-window route forced on the
    #     same call); each route forced on c5's own shapes (2 frames) and
    #     bit-equal to the staged route
    c5s, c5src, _ = c5_args()
    plan5s = plan_pipeline(c5s, c5src, OutputDescriptor(
        width=SMALL_W, height=SMALL_H, bits=8))
    c5b = [p010_batch(BATCH, SEED + 75 + i, dev) for i in range(2)]
    probe_sess = DeinterlaceSession(plan5s, pack_surface=True, device=dev)
    with recording(dk, "deint3_rows_dual", "cols3_tail") as calls:
        probe_sess.push_batch(c5b[0])
    torch.cuda.synchronize()
    (a7, kw7, got7), = calls["deint3_rows_dual"]
    (a9, kw9, got9), = calls["cols3_tail"]
    del calls
    routes5 = {"k7": dk.k7_route(a7[0][0].element_size(), a7[3], a7[4]),
               "k9": dk.k9_route(a9[0].element_size(), a9[1].element_size(),
                                 a9[3], a9[4])}
    err("k7", max((g - r).abs().max().item() for g, r in zip(
        got7, dk.deint3_rows_dual_plain(*a7, **kw7))))
    d9 = code_diff(got9, dk.cols3_tail_plain(*a9, **kw9), 8)
    err("k9", d9["max_code_diff"] / 255.0)
    k7_small_ms = cuda_ms(lambda: dk.deint3_rows_dual(*a7, **kw7))
    k9_small_ms = cuda_ms(lambda: dk.cols3_tail(*a9, **kw9))
    # K9's long-window route forced on c5 small's own call: bit-equal
    long9s = forced_long(dk, "K9_LONG_WINDOW",
                         lambda: dk.cols3_tail(*a9, **kw9))
    torch.cuda.synchronize()
    k9_small_long = {"bit_equal": bool(torch.equal(long9s, got9)),
                     "ms": forced_long(dk, "K9_LONG_WINDOW", lambda: cuda_ms(
                         lambda: dk.cols3_tail(*a9, **kw9)))}
    del a7, kw7, got7, a9, kw9, got9, probe_sess, long9s
    sess = DeinterlaceSession(plan5s, double_rate=True, pack_surface=True,
                              device=dev)

    def c5s_run():
        outs = []
        for b in c5b:
            outs += sess.push_batch(b)
        return outs + sess.flush_batch()

    outs, n_5 = count_launches(c5s_run)
    res["launches"]["c5_small"] = n_5
    f0, f1 = (tuple(p[i] for p in c5b[0]) for i in (0, 1))
    db_5 = [psnr(codes(outs[f][0], 8).double() / 255.0,
                 oracle_deint(f0, f0, f1, SMALL_W, SMALL_H, field=f))
            for f in (0, 1)]
    c5s_digest = digest(*outs)
    del outs
    sess_b = DeinterlaceSession(plan5s, pack_surface=True, device=dev)
    sess_b.push_batch(c5b[0])
    ms_5 = cuda_ms(lambda: sess_b.push_batch(c5b[1]), reps=2) / (2 * BATCH)
    # the forced routes on c5's own (1080p) shapes, 2 frames
    plan5 = plan_pipeline(*c5_args())
    wx5 = scale.upscale_matrix(Upscaling.LANCZOS3, W, OW)
    wy5 = scale.upscale_matrix(Upscaling.LANCZOS3, H, OH)
    ux5, uy5 = chroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, ChromaScaling.BILINEAR, plan5.src.chroma_location)
    norm = 1.0 / 65535.0
    k7args = (*[tuple(p[i:i + PLAIN_FRAMES] for p in c5b[0])
                for i in range(3)],
              rk.BandedMatrix(wy5, pre_scale=norm),
              rk.BandedMatrix(uy5 @ wy5, pre_scale=norm), OH,
              8.0 / 255.0 * 65535.0, True)
    staged7 = dk.deint3_rows_dual(*k7args)
    long7 = forced_long(dk, "K7_LONG_WINDOW",
                        lambda: dk.deint3_rows_dual(*k7args))
    k9args = (*(o.reshape((-1,) + o.shape[-2:]) for o in staged7),
              rk.BandedMatrix(wx5), rk.BandedMatrix(ux5 @ wx5), OW,
              _make_tail_epilogue(plan5))
    staged9 = dk.cols3_tail(*k9args, pack_format="rgba8")
    long9 = forced_long(dk, "K9_LONG_WINDOW", lambda: dk.cols3_tail(
        *k9args, pack_format="rgba8"))
    torch.cuda.synchronize()
    forced5 = {"k7_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(staged7, long7)),
               "k9_bit_equal": bool(torch.equal(staged9, long9)),
               "frames": PLAIN_FRAMES,
               "k7_long_window_ms": forced_long(
                   dk, "K7_LONG_WINDOW",
                   lambda: cuda_ms(lambda: dk.deint3_rows_dual(*k7args))),
               "k9_long_window_ms": forced_long(
                   dk, "K9_LONG_WINDOW", lambda: cuda_ms(
                       lambda: dk.cols3_tail(*k9args, pack_format="rgba8")))}
    del staged7, long7, staged9, long9, k7args, k9args, c5b, sess, sess_b
    if n_5 != only(deint3_rows_dual=3, cols3_tail=3) \
            or routes5["k7"] != "long-window" \
            or not k9_small_long["bit_equal"] \
            or min(db_5) < 55.0 or res["err"]["k7"] > 2e-5 \
            or d9["max_code_diff"] > 1 or d9["frac_differing"] >= 0.02 \
            or not (forced5["k7_bit_equal"] and forced5["k9_bit_equal"]):
        raise AssertionError(f"c5 small: launches {n_5}, routes {routes5}, "
                             f"PSNR {db_5}, K9 {d9}, forced {forced5}")
    line("c5_small", batch=BATCH, size=[SMALL_W, SMALL_H], launches=n_5,
         routes=routes5, psnr_db_field0=db_5[0], psnr_db_field1=db_5[1],
         ms_per_field=ms_5, k7_ms=k7_small_ms, k9_ms=k9_small_ms,
         k9_vs_plain=d9, k9_long_window=k9_small_long, digest=c5s_digest,
         forced_on_c5=forced5)
    torch.cuda.empty_cache()

    # 24. c8 small: c8's serving function -> 320 x 180 RGB10, two scenes,
    #     K1 x2 + K8 + K9 a call (K9 on its long-window route)
    meta = dovi_meta()
    st8, src8, _ = c8_args(meta)
    serve_s = make_serving_fn(plan_pipeline(st8, src8, OutputDescriptor(
        width=SMALL_W, height=SMALL_H, bits=10)), pack_surface=True)
    c8b = [p010_batch(BATCH, SEED + 80 + i, dev) for i in range(C8_SCENES)]
    rts = [{"dovi_curves": dovi_rt(i)} for i in range(C8_SCENES)]
    with recording(dk, "rows3_mid", "cols3_tail") as calls:
        serve_s(c8b[0], rts[0])
    torch.cuda.synchronize()
    (a8, kw8, got8), = calls["rows3_mid"]
    (a9, kw9, got9), = calls["cols3_tail"]
    del calls
    vals = a8[6].host_values().size
    routes8 = {"k8": "/".join(map(str, dk.k8_route(
                   a8[0].element_size(), a8[1].element_size(), a8[3], a8[4],
                   a8[7], a8[5], vals,
                   dk.k8_compiled_route(a8[0].dtype, a8[1].dtype, a8[6])))),
               "k9": dk.k9_route(4, 4, a9[3], a9[4])}
    err("k8", max((g - r).abs().max().item() for g, r in zip(
        got8, dk.rows3_mid_plain(*a8, **kw8))))
    d9s = code_diff(got9, dk.cols3_tail_plain(*a9, **kw9), 10)
    err("k9", d9s["max_code_diff"] / 1023.0)
    k8_small_ms = cuda_ms(lambda: dk.rows3_mid(*a8, **kw8))
    k9_c8small_ms = cuda_ms(lambda: dk.cols3_tail(*a9, **kw9))
    del a8, kw8, got8, a9, kw9, got9

    def c8s_run():
        return [serve_s(b, rt) for b, rt in zip(c8b[:2], rts[:2])]

    outs, n_8 = count_launches(c8s_run)
    res["launches"]["c8_small"] = n_8

    def c8_want(b, rt, w, h, rect=None):
        return oracle_dovi(*(p[0] for p in b), w, h,
                           curves=rt["dovi_curves"],
                           structure=dovi.curve_structure(meta),
                           ycc_to_rgb=meta.ycc_to_rgb_matrix,
                           ycc_offset=meta.ycc_to_rgb_offset,
                           lms=dovi.lms_pipeline_matrix(meta),
                           video_rect=rect)

    db_8 = psnr(codes(outs[0][0], 10).double() / 1023.0,
                c8_want(c8b[0], rts[0], SMALL_W, SMALL_H))
    c8s_digest = digest(*outs)
    del outs
    ms_8 = timed_calls(lambda b: serve_s(b, rts[1]), c8b[:2])
    if n_8 != only(banded_resize_last_axis=4, rows3_mid=2, cols3_tail=2) \
            or routes8["k9"] != "long-window" or db_8 < 55.0 \
            or res["err"]["k8"] > 1e-5 or d9s["max_code_diff"] > 1 \
            or d9s["frac_differing"] >= 0.02:
        raise AssertionError(f"c8 small: launches {n_8}, routes {routes8}, "
                             f"PSNR {db_8}, K8 {res['err']['k8']}, K9 {d9s}")
    line("c8_small", batch=BATCH, size=[SMALL_W, SMALL_H], launches=n_8,
         routes=routes8, psnr_db=db_8, ms_per_frame=ms_8,
         k8_ms=k8_small_ms, k9_ms=k9_c8small_ms, k9_vs_plain=d9s,
         digest=c8s_digest)

    # 25. c8 rect: c8's four scenes into the C8_RECT rect of a 1080p RGB10
    #     surface, K1 x2 + K8 + K9 with the offset a call; the rect
    #     bit-equal to the unplaced plan's surface, the bars the packed zero
    l, tp, r, bt = C8_RECT
    serve_r = make_serving_fn(plan_pipeline(st8, src8, OutputDescriptor(
        width=OW, height=OH, bits=10, video_rect=C8_RECT)),
        pack_surface=True)
    serve_u = make_serving_fn(plan_pipeline(st8, src8, OutputDescriptor(
        width=r - l, height=bt - tp, bits=10)), pack_surface=True)
    serve_r(c8b[0], rts[0])                     # warm-up, before the count

    def c8r_run():
        return [serve_r(b, rt) for b, rt in zip(c8b, rts)]

    outs, n_r = count_launches(c8r_run)
    res["launches"]["c8_rect"] = n_r
    rect8 = placed_check(outs, list(zip(c8b, rts)), C8_RECT,
                         lambda pair: serve_u(*pair))
    db_r = {f"scene{i}": psnr(
        codes(outs[i][0], 10).double() / 1023.0,
        c8_want(c8b[i], rts[i], OW, OH, C8_RECT)) for i in (0, C8_SCENES - 1)}
    c8r_digest = digest(*outs)
    del outs
    ms_r = cuda_ms(c8r_run, reps=1, warmup=0) / (C8_SCENES * BATCH)
    del c8b, serve_s, serve_r, serve_u
    if n_r != only(banded_resize_last_axis=2 * C8_SCENES,
                   rows3_mid=C8_SCENES, cols3_tail=C8_SCENES) \
            or not (rect8["bars_black"] and rect8["rect_bit_equal"]) \
            or min(db_r.values()) < 55.0:
        raise AssertionError(f"c8 rect: launches {n_r}, {rect8}, PSNR {db_r}")
    line("c8_rect", batch=BATCH, scenes=C8_SCENES, launches=n_r,
         psnr_db=db_r, ms_per_frame=ms_r, digest=c8r_digest, **rect8)
    torch.cuda.empty_cache()

    # 26. sdr2020: 4K P010 SDR with BT.2020 primaries (a UHD SDR broadcast
    #     signal, BT.1886: the fix's source gamma 2.2) -> 1080p RGB10
    #     dithered, K1 x3 + K2 (CORR_FIX_BT2020) a call
    set_s = Settings(upscaling=Upscaling.LANCZOS3, use_dither=True,
                     chroma_scaling=ChromaScaling.BILINEAR)
    src_s = SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                             matrix=CSP.BT_2020_NC, levels=Levels.TV,
                             primaries=Primaries.BT_2020, transfer=TRC.BT_1886)
    vp_s = VideoProcessor(set_s, src_s, OutputDescriptor(width=OW, height=OH,
                                                         bits=10),
                          device=dev, pack_surface=True)
    sb = [p010_batch(BATCH, SEED + 85 + i, dev) for i in range(2)]
    a2, kw2, got2 = one_call(rk, "rows3_tail", lambda: vp_s.process(sb[0]))
    fix = {"correction": a2[6].correction, "sdr_gamma": a2[6].sdr_gamma,
           "route": rk.rows3_tail_route(a2[0].dtype, a2[1].dtype, a2[6],
                                        kw2.get("pack_format")),
           **code_diff(got2, rk.rows3_tail_plain(*a2, **kw2), 10)}
    err("k2", fix["max_code_diff"] / 1023.0)
    fix["k2_ms"] = cuda_ms(lambda: rk.rows3_tail(*a2, **kw2))
    fix["k2_digest"] = digest(got2)
    del a2, kw2, got2
    outs, n_s = count_launches(lambda: [vp_s.process(b) for b in sb])
    res["launches"]["sdr2020"] = n_s
    db_s = psnr(codes(outs[0][0], 10).double() / 1023.0,
                oracle(*(p[0] for p in sb[0]), OW, OH, pq_to_sdr=False,
                       fix_bt2020_gamma=2.2))
    sdr_digest = digest(*outs)
    del outs
    ms_s = timed_calls(vp_s.process, sb)
    del sb, vp_s
    if n_s != only(banded_resize_last_axis=6, rows3_tail=2) \
            or fix["correction"] != rk.CORR_FIX_BT2020 \
            or fix["max_code_diff"] > 1 or fix["frac_differing"] >= 0.02 \
            or db_s < 55.0:
        raise AssertionError(f"sdr2020: launches {n_s}, K2 {fix}, PSNR "
                             f"{db_s}")
    line("sdr2020", batch=BATCH, launches=n_s, psnr_db=db_s,
         ms_per_frame=ms_s, k2=fix, digest=sdr_digest,
         tolerance="K2 <= 1 code on < 2% of channels")

    # 27. gray: 4K Y16 -> 1080p RGB10 dithered, K1 + K3 a call (K3's path)
    src_g = SourceDescriptor(format=ColorFormat.Y16, width=W, height=H,
                             matrix=CSP.BT_709, levels=Levels.TV)
    vp_g = VideoProcessor(set_s, src_g, OutputDescriptor(width=OW, height=OH,
                                                         bits=10),
                          device=dev, pack_surface=True)
    rng = np.random.default_rng(SEED + 90)
    gb = [(torch.from_numpy(rng.integers(64 << 8, 235 << 8, (BATCH, H, W),
                                         dtype=np.uint16)).to(dev),)
          for _ in range(2)]
    a3, kw3, got3 = one_call(rk, "banded_resize_rows",
                             lambda: vp_g.process(gb[0]))
    k3 = {"max_abs_err": (got3 - rk.banded_resize_rows_plain(*a3, **kw3))
          .abs().max().item(),
          "route": "/".join(map(str, rk.k3_route(a3[0].element_size(),
                                                 a3[1])))}
    k3["ms"] = cuda_ms(lambda: rk.banded_resize_rows(*a3, **kw3))
    k3["plain_ms"] = cuda_ms(lambda: rk.banded_resize_rows_plain(*a3, **kw3))
    dense3 = a3[1].dense_on(dev).T
    k3["library_ms"] = cuda_ms(lambda: torch.matmul(dense3, a3[0]))
    k3.update(bound(tbytes(a3[0]) + got3.numel() * 4 + mbytes(a3[1]),
                    map_flops(a3[1], a3[0].numel() // a3[1].in_size)))
    del a3, kw3, got3, dense3
    outs, n_g = count_launches(lambda: [vp_g.process(b) for b in gb])
    res["launches"]["gray"] = n_g
    db_g = psnr(codes(outs[0][0], 10).double() / 1023.0,
                oracle_gray(gb[0][0][0], OW, OH, matrix=CSP.BT_709,
                            levels=Levels.TV))
    gray_digest = digest(*outs)
    del outs
    ms_g = timed_calls(vp_g.process, gb)
    del gb, vp_g
    if n_g != only(banded_resize_last_axis=2, banded_resize_rows=2) \
            or k3["max_abs_err"] > 2e-6 or db_g < 55.0:
        raise AssertionError(f"gray: launches {n_g}, K3 {k3}, PSNR {db_g}")
    line("gray", batch=BATCH, launches=n_g, psnr_db=db_g, ms_per_frame=ms_g,
         k3=k3, digest=gray_digest, tolerance="K3 f32 <= 2e-6")
    res["k3"] = k3

    # 28. shader: the headline plan with vp_scaling=False: the convert at
    #     source resolution (K1 x2 on the chroma + K2 with the colour
    #     matrix and PQ -> SDR, float32 out), the torch resize and final
    #     pass; the convert's K1 and K2 calls against their plain versions
    #     on 2 frames
    set_h = Settings(upscaling=Upscaling.LANCZOS3,
                     chroma_scaling=ChromaScaling.BILINEAR,
                     convert_to_sdr=True, use_dither=True, vp_scaling=False)
    vp_sh = VideoProcessor(set_h, src, OutputDescriptor(width=OW, height=OH,
                                                        bits=10),
                           device=dev, pack_surface=True)
    hb = [p010_batch(BATCH, SEED + 95 + i, dev) for i in range(2)]
    with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
        vp_sh.process(tuple(p[:PLAIN_FRAMES] for p in hb[0]))
    torch.cuda.synchronize()
    sh = {"k1_max_abs_err": max(
        (o - rk.banded_resize_last_axis_plain(*a, **kw)).abs().max().item()
        for a, kw, o in calls["banded_resize_last_axis"])}
    (a2, kw2, got2), = calls["rows3_tail"]
    sh["k2_max_abs_err"] = (got2 - rk.rows3_tail_plain(*a2, **kw2)).abs() \
        .max().item()
    sh["k2_correction"] = a2[6].correction
    sh["k2_digest"] = digest(got2)
    err("k1", sh["k1_max_abs_err"])
    err("k2", sh["k2_max_abs_err"])
    del calls, a2, kw2, got2
    outs, n_h = count_launches(lambda: [vp_sh.process(b) for b in hb])
    res["launches"]["shader"] = n_h
    db_h = psnr(codes(outs[0][0], 10).double() / 1023.0,
                oracle(*(p[0] for p in hb[0]), OW, OH, shader_order=True))
    shader_digest = digest(*outs)
    del outs
    ms_h = timed_calls(vp_sh.process, hb)
    del hb, vp_sh
    if n_h != only(banded_resize_last_axis=4, rows3_tail=2) \
            or sh["k1_max_abs_err"] > 2e-5 or sh["k2_max_abs_err"] > 2e-4 \
            or sh["k2_correction"] != rk.CORR_PQ_TO_SDR or db_h < 55.0:
        raise AssertionError(f"shader: launches {n_h}, {sh}, PSNR {db_h}")
    line("shader", batch=BATCH, launches=n_h, psnr_db=db_h,
         ms_per_frame=ms_h, digest=shader_digest, **sh,
         tolerance="K1 f32 <= 2e-5; K2 float out with a correction <= 2e-4")
    torch.cuda.empty_cache()
    return res


def subtitle_overlay():
    """bench_common.subtitle_overlay(): a deterministic subtitle-style
    bitmap, rgb 0.95 and alpha 0.85 on about 55% of its pixels."""
    rng = np.random.default_rng(99)
    rgb = np.ones((3, SUB_H, SUB_W), np.float32) * 0.95
    alpha = (rng.random((SUB_H, SUB_W)) > 0.45).astype(np.float32) * 0.85
    return rgb, alpha


class FixedSubtitle:
    """A subtitle provider that serves one bitmap at every time."""

    def __init__(self, rgb, alpha, x: int, y: int):
        self.pics = [SubPic(rgb=rgb, alpha=alpha, x=x, y=y, start=0.0,
                            stop=float("inf"))]

    def render(self, t: float) -> list:
        return self.pics

    def next_change(self, t: float):
        return None


@contextlib.contextmanager
def osd_recording():
    """Keep every stats panel the renderer draws: (rgb, alpha) in order,
    and the host ms each took to rasterise (``kept.ms``)."""
    from videorenderer_tpu_torch import osd

    class Kept(list):
        ms: list

    kept, real = Kept(), osd.render_stats_overlay
    kept.ms = []

    def keep(*a, **kw):
        t0 = time.perf_counter()
        kept.append(real(*a, **kw))
        kept.ms.append((time.perf_counter() - t0) * 1e3)
        return kept[-1]

    osd.render_stats_overlay = keep
    try:
        yield kept
    finally:
        osd.render_stats_overlay = real


def p010_bytes(planes) -> np.ndarray:
    """(B, H, W) / (B, H/2, W/2) uint16 planes -> (B, n_words) P010
    buffers: the luma rows, then the interleaved chroma rows."""
    y, u, v = (np.ascontiguousarray(p) for p in planes)
    uv = np.stack([u, v], -1).reshape(y.shape[0], -1)
    return np.concatenate([y.reshape(y.shape[0], -1), uv], axis=1)


def v210_dwords(batch: int, seed: int, dev) -> np.ndarray:
    """(B, H * row_dwords) uint32 v210 frames of TV-range 10-bit codes,
    drawn on ``dev`` from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    row = ((W + 47) // 48) * 32
    c = torch.randint(64, 941, (batch, H * row, 3), generator=g,
                      device=dev, dtype=torch.int32)
    d = c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)
    return d.cpu().numpy().view(np.uint32)


def host_ms(fn, reps: int = 3) -> float:
    """Mean ms of ``fn()`` on the host clock, synced, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def renderer_phases(dev, c5_ms_per_field: float) -> dict:
    """Phases 32-35: the entry points a player drives.  c5s and the
    headline through api.VideoRenderer with overlays on the packed surface,
    device ingest (VideoProcessor.process_packed of P010 and v210 bytes)
    and the overlapped clip runner.  Every output is held bit-equal to the
    functions the entry point composes.  Returns each phase's launches."""
    res = {"launches": {}}
    src, dst = headline_args()
    t_phase = time.perf_counter()

    # 32. c5s: VideoRenderer on c5's interlaced source with a subtitle on
    #     every field, 16 frames pushed one at a time, then flush; K7 x1 +
    #     K9 x1 a pushed frame; each field bit-equal to the session + the
    #     packed blend
    settings5, src5, dst5 = c5_args()
    rgb, alpha = subtitle_overlay()
    vr = VideoRenderer(Settings(convert_to_sdr=True,
                                upscaling=Upscaling.LANCZOS3),
                       pack_surface=True, device=dev)
    vr.open(src5, dst5)
    vr.set_subtitle_provider(FixedSubtitle(rgb, alpha, SUB_X, SUB_Y))
    frames = p010_batch(BATCH, SEED + 110, dev)

    def push_all():
        outs = []
        for i in range(BATCH):
            outs += vr.process_frame(tuple(p[i] for p in frames),
                                     time=i / 50.0)
        return outs + vr.flush()

    fields, n32 = count_launches(push_all)
    res["launches"]["c5s"] = n32
    if n32 != only(deint3_rows_dual=BATCH, cols3_tail=BATCH):
        raise AssertionError(f"c5s launches {n32}")
    if len(fields) != 2 * BATCH or any(
            f.shape != (OH, OW) or f.dtype != torch.int32 for f in fields):
        raise AssertionError(f"c5s gave {len(fields)} fields "
                             f"{tuple(fields[0].shape)}")
    if (vr._plan.settings, vr._plan.dst) != (settings5, dst5):
        raise AssertionError("c5s: the renderer's plan is not c5's")
    rgb_d, a_d = (torch.as_tensor(a, device=dev) for a in (rgb, alpha))

    def sub(o):
        return blend_in_rect_packed(o, rgb_d, a_d, x=SUB_X, y=SUB_Y,
                                    fmt="rgba8")

    sess = DeinterlaceSession(vr._plan, pack_surface=True, device=dev)
    ref = []
    for i in range(BATCH):
        ref += sess.push(tuple(p[i] for p in frames))
    ref += sess.flush()
    equal32 = len(ref) == len(fields) and all(
        torch.equal(f, sub(r)) for f, r in zip(fields, ref))
    f0 = tuple(p[0] for p in frames)
    f1 = tuple(p[1] for p in frames)
    db32 = psnr(codes(fields[0], 8).double() / 255.0, blend_packed_codes(
        oracle_deint(f0, f0, f1, OW, OH, field=0), rgb, alpha, SUB_X, SUB_Y,
        8))
    digest32 = digest(*fields)
    del fields, ref, sess
    if not equal32 or db32 < 55.0:
        raise AssertionError(f"c5s: fields bit-equal {equal32}, PSNR {db32}")
    def renderer_ms(**queue) -> float:
        """ms a field through the renderer (a fresh window, synced per
        frame), with the subtitle queue ``queue`` gives or none."""
        vr.set_subtitle_provider(
            FixedSubtitle(rgb, alpha, SUB_X, SUB_Y) if queue else None,
            **queue)
        vr.open(src5, dst5)
        t0 = time.perf_counter()
        n = len(push_all())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    renderer = {"threaded_queue": renderer_ms(threaded=True),
                "render_on_demand_queue": renderer_ms(threaded=False),
                "no_overlay": renderer_ms()}
    # bench's form: push_batch at batch 16, the blend on each output
    sess_b = DeinterlaceSession(vr._plan, pack_surface=True, device=dev)
    sess_b.push_batch(frames)
    ms_blend = cuda_ms(lambda: [sub(o) for o in sess_b.push_batch(frames)],
                       reps=4) / (2 * BATCH)
    ms_bare = cuda_ms(lambda: sess_b.push_batch(frames), reps=4) / (2 * BATCH)
    outs16 = sess_b.push_batch(frames)
    blend_only = cuda_ms(lambda: sub(outs16[0])) / BATCH
    del outs16, sess_b
    line("c5s", seconds=time.perf_counter() - t_phase, frames=BATCH,
         fields=2 * BATCH, launches=n32,
         fields_bit_equal_session_blend=equal32, psnr_db_field0=db32,
         overlay=[SUB_W, SUB_H, SUB_X, SUB_Y], digest=digest32,
         renderer_ms_per_field=renderer, bench_ms_per_field=ms_blend,
         bench_ms_per_field_no_overlay=ms_bare,
         blend_ms_per_field=blend_only,
         c5_ms_per_field_phase14=c5_ms_per_field)
    vr.set_subtitle_provider(None)
    del vr
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # 33. the headline through the renderer: an SRT line through io.srt, a
    #     logo bitmap and the stats OSD on the packed RGB10 surface; each of
    #     16 frames bit-equal to VideoProcessor.process + the blends, K1 x3
    #     + K2 a frame; then rotation 180, a changed upscaler and back,
    #     the screenshots
    settings = dataclasses.replace(headline_settings(True), show_stats=True)
    vr = VideoRenderer(settings, pack_surface=True, device=dev)
    vr.open(src, dst)
    events = parse_srt(SRT_TEXT)
    for e in events:
        e.x, e.y = SRT_XY
    vr.set_subtitle_provider(TextSubtitleProvider(events, size=32))
    rng = np.random.default_rng(SEED + 120)
    logo = (rng.random((3, LOGO_H, LOGO_W)).astype(np.float32),
            np.full((LOGO_H, LOGO_W), 0.7, np.float32))
    vr.set_alpha_bitmap(*logo, *LOGO_XY)
    vp = VideoProcessor(settings, src, dst, device=dev, pack_surface=True)
    sub_pic, = TextSubtitleProvider(events, size=32).render(0.5)
    ovs = [(torch.as_tensor(sub_pic.rgb, device=dev),
            torch.as_tensor(sub_pic.alpha, device=dev), *SRT_XY),
           (torch.as_tensor(logo[0], device=dev),
            torch.as_tensor(logo[1], device=dev), *LOGO_XY)]

    def blends(out, panel):
        for orgb, oa, x, y in ovs:
            out = blend_in_rect_packed(out, orgb, oa, x=x, y=y,
                                       fmt="rgb10a2")
        prgb, pa = panel
        h, w = min(pa.shape[0], OH - 8), min(pa.shape[1], OW - 8)
        return blend_in_rect_packed(
            out, torch.as_tensor(prgb[:, :h, :w], device=dev),
            torch.as_tensor(pa[:h, :w], device=dev), x=8, y=8,
            fmt="rgb10a2")

    frames = p010_batch(BATCH, SEED + 121, dev)
    one = [tuple(p[i] for p in frames) for i in range(BATCH)]
    ms33 = []

    def render_all():
        outs = []
        for i, f in enumerate(one):
            t0 = time.perf_counter()
            outs.append(vr.process_frame(f, time=0.5 + i / 24.0))
            ms33.append((time.perf_counter() - t0) * 1e3)
        return outs

    with osd_recording() as panels:
        outs33, n33 = count_launches(render_all)
    res["launches"]["renderer"] = n33
    if n33 != only(banded_resize_last_axis=3 * BATCH, rows3_tail=BATCH):
        raise AssertionError(f"renderer launches {n33}")
    equal33 = len(panels) == BATCH and all(
        o.shape == (OH, OW) and torch.equal(o, blends(vp.process(f), pnl))
        for o, f, pnl in zip(outs33, one, panels))
    osd_ms = float(np.median(panels.ms[1:]))

    def no_panel(o, pnl):
        """The output with the stats panel's rect zeroed: the panel shows
        this run's timings, the rest of the surface is deterministic."""
        o = o.clone()
        o[8:8 + min(pnl[1].shape[0], OH - 8),
          8:8 + min(pnl[1].shape[1], OW - 8)] = 0
        return o

    digest33 = digest(*(no_panel(o, p) for o, p in zip(outs33, panels)))
    del outs33
    # rotation 180: the in-kernel pack kept, the packed dwords rotated
    vr.flt_set("rotation", 180)
    with osd_recording() as panels:
        rot = vr.process_frame(one[0], time=0.5)
    rot_equal = bool(torch.equal(rot, blends(
        rotate_flip(vp.process(one[0]), 180), panels[0])))
    vr.flt_set("rotation", 0)
    # a changed upscaler rebuilds once; the way back is a cache hit
    fn0, n_cache = vr._fn, len(vr._fn_cache)
    vr.set_settings(dataclasses.replace(settings,
                                        upscaling=Upscaling.CATMULL_ROM))
    rebuilt = vr._fn is not fn0 and len(vr._fn_cache) == n_cache + 1
    vr.set_settings(settings)
    cache_hit = vr._fn is fn0 and len(vr._fn_cache) == n_cache + 1
    disp = vr.get_displayed_image()
    bgr48_ok = (disp.shape == (OH, OW, 3) and disp.dtype == np.uint16
                and np.array_equal(disp, formats.rgb10_dwords_to_bgr48(
                    vr._last_output.cpu().numpy().view(np.uint32))))
    cur = vr.get_current_image()
    shot_fn = vr._shot_cache[1]
    cur_ok = (cur.shape == (H, W, 3) and cur.dtype == np.uint8
              and np.array_equal(vr.get_current_image(), cur)
              and vr._shot_cache[1] is shot_fn)
    if not (equal33 and rot_equal and rebuilt and cache_hit and bgr48_ok
            and cur_ok):
        raise AssertionError(
            f"renderer: bit-equal {equal33}, rotation {rot_equal}, rebuild "
            f"{rebuilt}, cache hit {cache_hit}, BGR48 {bgr48_ok}, current "
            f"image {cur_ok}")
    # the same frames with no overlay: what the overlays cost a frame
    vr.set_subtitle_provider(None)
    vr.set_alpha_bitmap(None, None)
    vr.flt_set("statsEnable", False)
    bare = []
    for i, f in enumerate(one):
        t0 = time.perf_counter()
        vr.process_frame(f, time=0.5 + i / 24.0)
        bare.append((time.perf_counter() - t0) * 1e3)
    line("renderer", seconds=time.perf_counter() - t_phase, frames=BATCH,
         launches=n33,
         outputs_bit_equal_process_blends=equal33,
         rotation180_bit_equal=rot_equal, upscaler_change_rebuilt=rebuilt,
         upscaler_back_cache_hit=cache_hit, displayed_image_bgr48=bgr48_ok,
         current_image_source_size=cur_ok, digest=digest33,
         ms_per_frame_synced_median=float(np.median(ms33[1:])),
         ms_per_frame_synced_p90=float(np.percentile(ms33[1:], 90)),
         ms_per_frame_no_overlay_median=float(np.median(bare[1:])),
         osd_raster_ms_median=osd_ms, overlays=["srt", "logo", "stats"])
    del vr, one, frames
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # 34. ingest: process_packed of 16 frames of 4K P010 and of v210 bytes
    #     -> 1080p RGB10, each bit-equal to process(unpack_frame(...)) on
    #     the card; ms a frame with the host->device copy, packed and planar
    ingest = {}
    v210_src = dataclasses.replace(src, format=ColorFormat.V210)
    for name, s, bufs in (
            ("p010", src, p010_bytes(tuple(
                p.cpu().numpy() for p in p010_batch(BATCH, SEED + 130,
                                                    "cpu")))),
            ("v210", v210_src, v210_dwords(BATCH, SEED + 131, dev))):
        vpi = VideoProcessor(headline_settings(True), s, dst, device=dev,
                             pack_surface=True)
        packed, n = count_launches(lambda: vpi.process_packed(bufs))
        res["launches"][f"ingest_{name}"] = n
        t0 = time.perf_counter()
        host = [formats.unpack_frame(s.format, b.tobytes(), W, H).planes
                for b in bufs]
        unpack_ms = (time.perf_counter() - t0) * 1e3 / BATCH
        planar = tuple(np.stack(p) for p in zip(*host))
        del host
        equal = bool(torch.equal(packed, vpi.process(planar)))
        ingest[name] = {
            "launches": n, "bit_equal_process_unpack_frame": equal,
            "digest": digest(packed),
            "packed_ms_per_frame": host_ms(
                lambda: vpi.process_packed(bufs)) / BATCH,
            "planar_ms_per_frame": host_ms(
                lambda: vpi.process(planar)) / BATCH,
            "host_unpack_ms_per_frame": unpack_ms,
            "packed_mb_per_frame": bufs[0].nbytes / 1e6,
            "planar_mb_per_frame": sum(p[0].nbytes for p in planar) / 1e6}
        del packed, planar, bufs, vpi
        if n != only(banded_resize_last_axis=3, rows3_tail=1) or not equal:
            raise AssertionError(f"ingest {name}: {ingest[name]}")
    line("ingest", seconds=time.perf_counter() - t_phase, frames=BATCH,
         **ingest)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # 35. clip: run_clip of the headline over 4 host batches of 16 (pinned
    #     staging, a side copy stream), each output bit-equal to
    #     VideoProcessor.process of its batch; frames/s overlapped and
    #     serial (put, compute, sync)
    vp = VideoProcessor(headline_settings(True), src, dst, device=dev,
                        pack_surface=True)
    host = [tuple(p.cpu().numpy() for p in p010_batch(BATCH, SEED + 140 + k,
                                                        "cpu"))
            for k in range(CLIP_BATCHES)]
    clip, n35 = count_launches(lambda: run_clip(vp.process, host,
                                                device=dev))
    res["launches"]["clip"] = n35
    equal35 = clip.frames == CLIP_BATCHES * BATCH and all(
        torch.equal(o, vp.process(b)) for o, b in zip(clip.outputs, host))
    digest35 = digest(*clip.outputs)
    del clip
    fps_overlapped = run_clip(vp.process, host, device=dev).fps

    def serial():
        for b in host:
            planes = tuple(torch.as_tensor(p, device=dev) for p in b)
            torch.cuda.synchronize()
            vp.process(planes)
            torch.cuda.synchronize()

    serial()
    t0 = time.perf_counter()
    serial()
    fps_serial = CLIP_BATCHES * BATCH / (time.perf_counter() - t0)
    if n35 != only(banded_resize_last_axis=3 * CLIP_BATCHES,
                   rows3_tail=CLIP_BATCHES) or not equal35:
        raise AssertionError(f"clip: launches {n35}, bit-equal {equal35}")
    line("clip", seconds=time.perf_counter() - t_phase,
         batches=CLIP_BATCHES, batch=BATCH, launches=n35,
         outputs_bit_equal_process=equal35, digest=digest35,
         fps_overlapped=fps_overlapped, fps_serial=fps_serial)
    del host, vp
    torch.cuda.empty_cache()
    return res


def cli_settings(**kw) -> Settings:
    """The Settings ``cli process`` builds from its default flags (an SDR
    display: no HDR passthrough), with ``kw`` on top."""
    return Settings(hdr_passthrough=False, **kw)


def model_renderer(dev, key: str):
    """c3sr's or c1vh's renderer on ``dev`` (bench_common.py:188-199, the
    batches :242-251): 1080p NV12 BT.709 TV -> 4K RGBA8 under SuperRes
    P1080, or -> 1080p RGB10 for an HDR display under VideoHDR, packed, the
    shipped weights loaded on the CPU and given to the hook, opened.
    Returns (renderer, the caller's model, the output)."""
    src = SourceDescriptor(format=ColorFormat.NV12, width=C1_W, height=C1_H,
                           matrix=CSP.BT_709, levels=Levels.TV)
    if key == "c3sr":
        settings = Settings(vp_superres=SuperResolution.P1080)
        dst = OutputDescriptor(width=2 * C1_W, height=2 * C1_H, bits=8)
        model = real_eval.load_shipped_superres("cpu")
    else:
        settings = Settings(vp_rtx_video_hdr=True)
        dst = OutputDescriptor(width=C1_W, height=C1_H, bits=10, hdr=True)
        model = real_eval.load_shipped_videohdr("cpu")
    vr = VideoRenderer(settings, pack_surface=True, device=dev)
    (vr.set_superres_params if key == "c3sr"
     else vr.set_videohdr_params)(model)
    vr.open(src, dst)
    return vr, model, dst


def model_phase(dev, key: str) -> dict:
    """Phase 36 (c3sr) or 37 (c1vh): the shipped model through
    api.VideoRenderer(pack_surface=True) at full width.  The pipeline runs
    1:1 on c1's route (K1 x2 + K2, float output), then the net, then the
    pack; the path's K1 and K2 calls against their plain versions on
    PLAIN_FRAMES frames; every output bit-equal to pack(net(pipeline));
    frame 0 >= 40 dB against the float64 oracle then the same net.
    Returns the phase's launches and the kernels' errors."""
    sr = key == "c3sr"
    batch, bits = (SR_BATCH, 8) if sr else (VH_BATCH, 10)
    fmt = "rgba8" if sr else "rgb10a2"
    mod = sr_model if sr else vh_model
    t_phase = time.perf_counter()
    vr, model, dst = model_renderer(dev, key)
    net = vr._superres if sr else vr._videohdr
    weights = {"on_device": all(p.device.type == dev.type
                                for p in net.parameters()),
               "caller_model_on_cpu": all(p.device.type == "cpu"
                                          for p in model.parameters())}
    engaged = vr._superres_engaged() if sr else vr._videohdr_engaged()
    info = vr.get_output_signal_info().to_dict()
    info_ok = (info["width"], info["height"], info["bits"]) == (
        dst.width, dst.height, bits) and (sr or (
            info["transfer"], info["primaries"]) == ("PQ", "BT_2020"))
    if not (engaged and info_ok and all(weights.values())
            and (vr._plan.dst.width, vr._plan.dst.height) == (C1_W, C1_H)):
        raise AssertionError(f"{key}: engaged {engaged}, signal info {info}, "
                             f"weights {weights}, plan {vr._plan.dst}")
    frames = nv12_batch(batch, SEED + (150 if sr else 151), dev)
    vr.process_frame(tuple(p[:1] for p in frames))          # warm-up
    # the path's K1 and K2 calls on PLAIN_FRAMES frames against their
    # plain versions on the same inputs
    with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
        vr.process_frame(tuple(p[:PLAIN_FRAMES] for p in frames))
    torch.cuda.synchronize()
    k1_calls, k2_calls = calls["banded_resize_last_axis"], calls["rows3_tail"]
    if len(k1_calls) != 2 or len(k2_calls) != 1:
        raise AssertionError(f"{key} recorded {len(k1_calls)} K1 and "
                             f"{len(k2_calls)} K2 calls")
    kk = {"k1_max_code_diff": 0, "k1_max_abs_err": 0.0}
    for a, kw, got in k1_calls:
        err = (got.float() - rk.banded_resize_last_axis_plain(*a, **kw)
               .float()).abs().max().item()
        if got.dtype == torch.int16:
            kk["k1_max_code_diff"] = max(kk["k1_max_code_diff"], int(err))
        else:
            kk["k1_max_abs_err"] = max(kk["k1_max_abs_err"], err)
    (a, kw, got), = k2_calls
    if kw.get("pack_format") is not None or got.dtype != torch.float32:
        raise AssertionError(f"{key}: K2 packed {kw.get('pack_format')}")
    kk.update({"k2_" + k: v for k, v in float_code_diff(
        got, rk.rows3_tail_plain(*a, **kw), 2 ** bits - 1).items()})
    kk["k1_digest"] = digest(*(o for _, _, o in k1_calls))
    kk["k2_digest"] = digest(got)
    del calls, k1_calls, k2_calls, a, kw, got
    if kk["k1_max_code_diff"] > 1 or kk["k1_max_abs_err"] > 2e-5 \
            or kk["k2_max_code_diff"] > 1 or kk["k2_frac_differing"] >= 0.02:
        raise AssertionError(f"{key}: K1 or K2 disagrees with its plain "
                             f"version: {kk}")
    # one call at the full batch, counted
    out, n = count_launches(lambda: vr.process_frame(frames))
    if n != only(banded_resize_last_axis=2, rows3_tail=1):
        raise AssertionError(f"{key} launches {n}")
    if out.shape != (batch, dst.height, dst.width) or out.dtype != torch.int32:
        raise AssertionError(f"{key} output {tuple(out.shape)} {out.dtype}")
    base = make_frame_fn(vr._plan)
    rgb = base(frames)
    enhanced = mod.enhance_plane_chw(net, rgb)
    composed = bool(torch.equal(out, rk.pack_surface(enhanced, fmt)))
    # frame 0 against the float64 oracle of the 1:1 plan, then the net
    ref = oracle(frames[0][0], frames[1][0], frames[2][0], C1_W, C1_H,
                 bits_in=8, matrix=CSP.BT_709, pq_to_sdr=False,
                 dither_bits=bits)
    db = {"pipeline": psnr(rgb[0], ref),
          "output": psnr(codes(out[0], bits).double() / (2 ** bits - 1),
                         mod.enhance_plane_chw(net, ref[None].float())[0]
                         .clamp(0.0, 1.0))}
    out_digest = digest(out)
    del out, ref
    wrong_device = "not checked on the CPU"
    if dev.type == "cuda":
        try:
            mod.enhance_plane_chw(model, rgb)
            wrong_device = "ran"
        except RuntimeError:
            wrong_device = "raised"
    ms = {"pipeline": cuda_ms(lambda: base(frames)) / batch,
          "net": cuda_ms(lambda: mod.enhance_plane_chw(net, rgb)) / batch,
          "pack": cuda_ms(lambda: rk.pack_surface(enhanced, fmt)) / batch,
          "renderer": cuda_ms(lambda: vr.process_frame(frames)) / batch}
    # the net's convolution FLOPs a frame (multiply-adds x 2), on the s2d grid
    k = model.cfg.s2d
    cells = -(-C1_H // k) * -(-C1_W // k)
    net_flop = conv_flops(net, cells)
    del rgb, enhanced, frames, base
    if not composed or min(db.values()) < 40.0 or db["pipeline"] < 55.0 \
            or wrong_device == "ran":
        raise AssertionError(f"{key}: composed {composed}, PSNR {db}, a "
                             f"model on the wrong device {wrong_device}")
    line(key, seconds=time.perf_counter() - t_phase, batch=batch,
         launches={k: v for k, v in n.items() if v}, engaged=engaged,
         signal_info=info, weights=weights,
         output_bit_equal_pack_net_pipeline=composed, psnr_db=db,
         ms_per_frame=ms, net_gflop_per_frame=net_flop / 1e9,
         net_tflop_s=net_flop / (ms["net"] * 1e-3) / 1e12,
         model_on_wrong_device=wrong_device, digest=out_digest,
         tolerance="K1 mid16 <= 1 code, f32 <= 2e-5; K2 <= 1 code on < 2%; "
                   "the output >= 40 dB, the pipeline >= 55 dB vs the "
                   "float64 oracle", **kk)
    del vr, net, model
    torch.cuda.empty_cache()
    return {"launches": n, "k1": kk["k1_max_abs_err"],
            "k2": kk["k2_max_code_diff"] / (2 ** bits - 1)}


def _bmp_pixels(path: str, w: int, h: int) -> np.ndarray:
    """(h, w, 3) RGB of a 24-bit bottom-up BMP whose rows need no pad."""
    with open(path, "rb") as f:
        data = f.read()
    return np.frombuffer(data[54:], np.uint8).reshape(h, w, 3)[::-1, :, ::-1]


def sr_clip(tmp: str, name: str):
    """Phase 38's clip: CLI_SR_FRAMES 1080p 4:2:0 frames of noise (SEED +
    160) written to ``tmp``/``name``.y4m.  Returns its path, its (Y, U, V)
    planes and its SourceDescriptor."""
    rng = np.random.default_rng(SEED + 160)
    yuv = (rng.integers(16, 236, (CLI_SR_FRAMES, C1_H, C1_W), np.uint8),
           rng.integers(16, 241, (CLI_SR_FRAMES, C1_H // 2, C1_W // 2),
                        np.uint8),
           rng.integers(16, 241, (CLI_SR_FRAMES, C1_H // 2, C1_W // 2),
                        np.uint8))
    clip = os.path.join(tmp, f"{name}.y4m")
    write_y4m(clip, zip(*yuv), C1_W, C1_H, fps=(24, 1))
    return clip, yuv, SourceDescriptor(
        format=ColorFormat.YUV420P8, width=C1_W, height=C1_H,
        matrix=CSP.BT_709, levels=Levels.TV,
        chroma_location=ChromaLocation.MPEG2)


def drive_process(dev, tmp: str, name: str, argv, ref_vr, ref_frames,
                  bits: int, fields: bool = False):
    """``cli process`` of ``argv`` into ``tmp``/``name``.rgb on ``dev`` in
    this process, its launches counted; then ``ref_frames`` through the
    opened renderer ``ref_vr`` into a RawVideoSink (``fields``: one frame a
    call, then the flush), its launches counted too.  Returns (the run's
    record: exit code, launches, the output file byte-equal to the
    renderer's, the same launches as the renderer's, frames, seconds,
    digest; the CLI's launches; the renderer's file)."""
    out = os.path.join(tmp, f"{name}.rgb")
    t0 = time.perf_counter()
    rc, n = count_launches(lambda: cli_main(
        ["process", *argv, "--out", out, "--device", dev.type]))
    seconds = time.perf_counter() - t0
    ref = os.path.join(tmp, f"{name}_ref.rgb")

    def present():
        with RawVideoSink(ref, bits=bits) as sink:
            if fields:
                for f in ref_frames:
                    for o in ref_vr.process_frame(f):
                        sink.present(o)
                for o in ref_vr.flush():
                    sink.present(o)
            else:
                sink.present(ref_vr.process_frame(ref_frames))
        return sink

    sink, n_ref = count_launches(present)
    with open(out, "rb") as f:
        out_digest = hashlib.sha256(f.read()).hexdigest()
    return ({"rc": rc, "launches": {k: v for k, v in n.items() if v},
             "bit_equal_renderer": rc == 0 and filecmp.cmp(out, ref,
                                                           shallow=False),
             "launches_equal_renderer": n == n_ref,
             "frames_out": sink.frames, "seconds": seconds,
             "frames_per_s": sink.frames / seconds, "digest": out_digest},
            n, ref)


def cli_phase(dev, tmp: str) -> dict:
    """Phase 38: ``cli.main`` in this process, three runs: a .y4m clip of
    CLI_SR_FRAMES 1080p 4:2:0 frames to 4K with the shipped SuperRes and a
    BMP screenshot; CLI_HEAD_FRAMES raw 4K P010 frames to 1080p RGB10 with
    the headline's flags; CLI_DEINT_FRAMES raw 4K P010 HLG frames
    deinterlaced at double rate.  Each output file byte-equal to the
    renderer's output on the same frames through RawVideoSink, the
    screenshot to its first frame; each run's launches counted; ``cli
    info`` names the device."""
    t_phase = time.perf_counter()
    sr_weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "weights", "superres_2x.npz")
    runs, launches = {}, {}

    def drive(name, argv, ref_vr, ref_frames, bits, fields=False):
        runs[name], launches[name], ref = drive_process(
            dev, tmp, name, argv, ref_vr, ref_frames, bits, fields)
        return ref

    # run 1: c3sr from a .y4m file
    clip, yuv, src = sr_clip(tmp, "c3sr")
    vr = VideoRenderer(cli_settings(vp_superres=SuperResolution.P1080),
                       device=dev)
    vr.set_superres_params(load_params(sr_weights, sr_model.SuperRes()))
    vr.open(src, OutputDescriptor(width=2 * C1_W, height=2 * C1_H, bits=8))
    shot = os.path.join(tmp, "c3sr.bmp")
    ref = drive("c3sr", [clip, "--out-size", f"{2 * C1_W}x{2 * C1_H}",
                              "--matrix", "BT_709", "--levels", "TV",
                              "--superres", "P1080", "--superres-weights",
                              sr_weights, "--screenshot", shot],
                vr, yuv, 8)
    first = np.fromfile(ref, np.uint8, count=4 * C1_H * C1_W * 3).reshape(
        2 * C1_H, 2 * C1_W, 3)
    runs["c3sr"]["screenshot_equal_first_frame"] = bool(np.array_equal(
        _bmp_pixels(shot, 2 * C1_W, 2 * C1_H), first))
    del vr, yuv, first
    # run 2: the headline from a raw P010 file
    hdr_src = dict(format=ColorFormat.P010, width=W, height=H,
                   matrix=CSP.BT_2020_NC, levels=Levels.TV,
                   primaries=Primaries.BT_2020)
    hdr_flags = ["--format", "P010", "--size", f"{W}x{H}", "--out-size",
                 f"{OW}x{OH}", "--primaries", "BT_2020", "--matrix",
                 "BT_2020_NC", "--levels", "TV", "--upscaling", "LANCZOS3"]
    head = tuple(p.cpu().numpy() for p in p010_batch(CLI_HEAD_FRAMES,
                                                      SEED + 161, "cpu"))
    raw = os.path.join(tmp, "headline.p010")
    p010_bytes(head).tofile(raw)
    vr = VideoRenderer(cli_settings(upscaling=Upscaling.LANCZOS3), device=dev)
    vr.open(SourceDescriptor(transfer=TRC.PQ, **hdr_src),
            OutputDescriptor(width=OW, height=OH, bits=10))
    drive("headline", [raw, *hdr_flags, "--transfer", "PQ", "--out-bits",
                       "10", "--batch", str(CLI_HEAD_FRAMES)], vr, head, 10)
    del vr, head
    # run 3: double-rate deinterlacing of HLG from a raw P010 file
    deint = tuple(p.cpu().numpy() for p in p010_batch(CLI_DEINT_FRAMES,
                                                       SEED + 162, "cpu"))
    raw = os.path.join(tmp, "c5.p010")
    p010_bytes(deint).tofile(raw)
    vr = VideoRenderer(cli_settings(upscaling=Upscaling.LANCZOS3), device=dev)
    vr.open(SourceDescriptor(transfer=TRC.HLG, interlaced=True, **hdr_src),
            OutputDescriptor(width=OW, height=OH, bits=8))
    drive("c5", [raw, *hdr_flags, "--transfer", "HLG", "--deinterlace",
                 "double"], vr,
          [tuple(p[i] for p in deint) for i in range(CLI_DEINT_FRAMES)], 8,
          fields=True)
    del vr, deint
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_info = cli_main(["info", "--device", dev.type])
    device_name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu")
    info_ok = rc_info == 0 and f"Device: {device_name}" in buf.getvalue()
    want = {"c3sr": only(banded_resize_last_axis=2, rows3_tail=1),
            "headline": only(banded_resize_last_axis=3, rows3_tail=1),
            "c5": only(deint3_rows_dual=CLI_DEINT_FRAMES,
                       cols3_tail=CLI_DEINT_FRAMES)}
    ok = (info_ok and launches == want and all(
        r["rc"] == 0 and r["bit_equal_renderer"] for r in runs.values())
        and runs["c3sr"]["screenshot_equal_first_frame"]
        and [r["frames_out"] for r in runs.values()] == [
            CLI_SR_FRAMES, CLI_HEAD_FRAMES, 2 * CLI_DEINT_FRAMES])
    line("cli", seconds=time.perf_counter() - t_phase, runs=runs,
         info_names_device=info_ok, device_name=device_name)
    if not ok:
        raise AssertionError(f"cli: runs {runs}, info {info_ok}, launches "
                             f"{launches} (want {want})")
    return launches


def model_cli_phases(dev) -> dict:
    """Phases 36-38: c3sr and c1vh through the renderer with the shipped
    weights, then the command line.  Returns each phase's launches and the
    kernels' largest errors against their plain versions."""
    dev = torch.device(dev)
    res = {"launches": {}, "err": {"k1": 0.0, "k2": 0.0}}
    for key in ("c3sr", "c1vh"):
        r = model_phase(dev, key)
        res["launches"][key] = r["launches"]
        for k in ("k1", "k2"):
            res["err"][k] = max(res["err"][k], r[k])
    with tempfile.TemporaryDirectory() as tmp:
        for name, n in cli_phase(dev, tmp).items():
            res["launches"][f"cli_{name}"] = n
    return res


def conv_flops(model, cells: int) -> int:
    """FLOPs (multiply-adds x 2) of a model's 3x3 convs over ``cells``
    cells of its grid."""
    return 2 * 9 * cells * sum(p.shape[0] * p.shape[1]
                               for n, p in model.named_parameters()
                               if n.endswith("weight"))


def step_flops(model, cells: int) -> int:
    """FLOPs of a training step's convs over ``cells`` cells: the forward,
    each conv's weight gradient, and the input gradient of every conv but
    the first, whose input (the data) needs none."""
    first = next(p for n, p in model.named_parameters()
                 if n.endswith("weight"))
    return 3 * conv_flops(model, cells) - 2 * 9 * cells * (
        first.shape[0] * first.shape[1])


def timed_steps(run):
    """``run()``, a trainer's run, with a CUDA event recorded on the
    current stream as each of its steps starts and as it ends: the
    trainers' loop (``optim.fit``) takes its step from
    ``optim.train_step``, which is wrapped for the run.  Returns
    (``run()``'s result, each step's (start, end) events, each step's
    start on the host clock and the host clock after the run)."""
    events, host = [], []
    real = optim.train_step

    def timed(*args, **kwargs):
        step = real(*args, **kwargs)

        def stepped(xb, yb):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            host.append(time.perf_counter())
            e0.record()
            loss = step(xb, yb)
            e1.record()
            events.append((e0, e1))
            return loss

        return stepped

    optim.train_step = timed
    try:
        out = run()
    finally:
        optim.train_step = real
    torch.cuda.synchronize()
    return out, events, host, time.perf_counter()


def train_phase(dev, key: str) -> dict:
    """Phase 39 (train_sr) or 40 (train_hdr): the trainer at full width
    from init_params(seed 0) on TRAIN_FRAMES synthetic frames, batch
    TRAIN_BATCH, patch TRAIN_PATCH.  TRAIN_CPU_STEPS steps twice on the
    card (whether the two are bit-equal is recorded, not gated: cuDNN's
    weight gradients may be non-deterministic) and once on the CPU, each
    loss within 1%; TRAIN_STEPS steps, every loss finite and the mean of
    the last 8 below that of the first 8; ms/step over that run's steps
    TRAIN_TIMED_FROM to TRAIN_STEPS from CUDA events recorded around each
    (:func:`timed_steps`); the step's TFLOP/s from the conv shapes
    (:func:`step_flops`); the parameters' digest and the held-out PSNR
    (not gated).  Returns the SR frames and start for phase 41."""
    sr = key == "train_sr"
    t_phase = time.perf_counter()
    if sr:
        cfg, mod, train = SR_TRAIN_CFG, sr_model, sr_train.train
        frames = sr_train.synth_frames(SEED, TRAIN_FRAMES, TRAIN_PATCH)
        val = sr_train.synth_frames(SEED + 777, TRAIN_VAL_FRAMES, TRAIN_PATCH)
        cells = (TRAIN_PATCH // cfg.scale // cfg.s2d) ** 2
    else:
        cfg, mod, train = VH_TRAIN_CFG, vh_model, hdr_train.train
        frames = hdr_train.synth_hdr_frames(SEED, TRAIN_FRAMES, TRAIN_PATCH,
                                            cfg)
        val = hdr_train.synth_hdr_frames(SEED + 777, TRAIN_VAL_FRAMES,
                                         TRAIN_PATCH, cfg)
        cells = (TRAIN_PATCH // cfg.s2d) ** 2
    start = mod.init_params(torch.Generator().manual_seed(SEED), cfg)

    def run(steps, device):
        return train(cfg, steps, TRAIN_BATCH, frames, seed=SEED,
                     learning_rate=TRAIN_LR, model=start, device=device)

    def params_digest(model):
        return digest(*model.state_dict().values())

    first = [run(TRAIN_CPU_STEPS, dev) for _ in range(2)]
    t_cpu = time.perf_counter()
    cpu = run(TRAIN_CPU_STEPS, "cpu")
    t_cpu = time.perf_counter() - t_cpu
    first_rel = max(abs(a - b) / b for a, b in zip(first[0][1], cpu[1]))
    repeat_equal = (first[0][1] == first[1][1] and params_digest(
        first[0][0]) == params_digest(first[1][0]))
    t_train = time.perf_counter()
    (model, losses), events, host, t_end = timed_steps(
        lambda: run(TRAIN_STEPS, dev))
    t_train = time.perf_counter() - t_train
    if len(events) != TRAIN_STEPS:
        raise AssertionError(f"{key}: {len(events)} steps timed of "
                             f"{TRAIN_STEPS}")
    n_timed = TRAIN_STEPS - TRAIN_TIMED_FROM
    ms_step = events[TRAIN_TIMED_FROM][0].elapsed_time(events[-1][1]) \
        / n_timed
    host_ms_step = 1e3 * (t_end - host[TRAIN_TIMED_FROM]) / n_timed
    fwd = conv_flops(model, TRAIN_BATCH * cells)
    flop = step_flops(model, TRAIN_BATCH * cells)
    head, tail = np.mean(losses[:8]), np.mean(losses[-8:])
    falling = bool(np.isfinite(losses).all() and tail < head)
    master = all(p.dtype == torch.float32 and p.device.type == dev.type
                 for p in model.parameters())
    if sr:
        net_db, base_db = sr_train.evaluate_psnr(model, val)
        val_db = {"net": net_db, "catmull_rom": base_db}
    else:
        net_db, base_db = hdr_train.evaluate_pq_psnr(model, val)
        val_db = {"net_pq": net_db, "base_pq": base_db}
    line(key, seconds=time.perf_counter() - t_phase, batch=TRAIN_BATCH,
         patch=TRAIN_PATCH, frames=TRAIN_FRAMES, steps=TRAIN_STEPS,
         lr=TRAIN_LR, losses=losses, loss_head8=head, loss_tail8=tail,
         first_losses_card=first[0][1], first_losses_cpu=cpu[1],
         first_max_rel=first_rel, cpu_seconds=t_cpu,
         card_repeat_bit_equal=repeat_equal, master_float32=master,
         train_seconds=t_train, ms_per_step=ms_step,
         host_ms_per_step=host_ms_step,
         forward_gflop_per_step=fwd / 1e9, gflop_per_step=flop / 1e9,
         tflop_s=flop / (ms_step * 1e-3) / 1e12,
         bound_ms_per_step=1e3 * flop / PEAK_BF16_S,
         params_digest=params_digest(model), val_psnr_db=val_db,
         tolerance="first steps within 1% of the CPU's; losses finite and "
                   "falling")
    if not (falling and first_rel <= 0.01 and master):
        raise AssertionError(f"{key}: losses {losses}, card {first[0][1]} "
                             f"vs CPU {cpu[1]}, float32 masters {master}")
    del model, first, cpu
    torch.cuda.empty_cache()
    return {"frames": frames, "start": start}


def dp_phase(dev, data, start) -> None:
    """Phase 41 (train_dp): make_mesh on one device (a world of one from a
    FileStore: NCCL on the card), DP_STEPS SuperRes steps with ``mesh=``
    against without: the losses and the parameters bit-equal; then the
    group destroyed."""
    import torch.distributed as dist
    t_phase = time.perf_counter()

    def run(mesh):
        return sr_train.train(SR_TRAIN_CFG, DP_STEPS, TRAIN_BATCH, data,
                              seed=SEED, learning_rate=TRAIN_LR, mesh=mesh,
                              model=start, device=dev)

    plain, plain_losses = run(None)
    mesh = make_mesh(device=dev.type)
    try:
        backend = dist.get_backend()
        meshed, mesh_losses = run(mesh)
    finally:
        mesh.destroy()
    equal = plain_losses == mesh_losses and digest(
        *plain.state_dict().values()) == digest(*meshed.state_dict().values())
    line("train_dp", seconds=time.perf_counter() - t_phase, steps=DP_STEPS,
         backend=backend, ranks=mesh.size, device=str(mesh.device),
         bit_equal_no_mesh=equal, losses=mesh_losses,
         group_destroyed=not dist.is_initialized())
    if not equal or dist.is_initialized():
        raise AssertionError(f"train_dp: mesh losses {mesh_losses} vs "
                             f"{plain_losses}, group left "
                             f"{dist.is_initialized()}")


TRAIN_KEYS = {  # the JSON keys of the JAX CLI's train commands (cli.py)
    "train-superres": {"steps", "final_loss", "val_psnr_net_db",
                       "val_psnr_catmull_db", "out"},
    "train-videohdr": {"steps", "final_loss", "val_pq_psnr_net_db",
                       "val_pq_psnr_base_db", "out"}}


def train_cli_phase(dev, tmp: str) -> dict:
    """Phase 42 (train_cli): ``cli train-superres`` and ``train-videohdr``
    (CLI_TRAIN_STEPS steps on CLI_TRAIN_FRAMES frames, batch and patch as
    phases 39-40) in this process, their JSON keys those of the JAX CLI,
    then ``cli process`` of phase 38's .y4m clip with each checkpoint
    (--superres P1080 to 4K; --videohdr-weights to an HDR display,
    RGB10): exit 0, the output file byte-equal to the renderer's with the
    checkpoint loaded, the same launches.  Returns each run's launches."""
    t_phase = time.perf_counter()
    clip, yuv, src = sr_clip(tmp, "train_cli")
    runs, launches = {}, {}
    for cmd, flags, bits in (
            ("train-superres", ["--superres", "P1080", "--out-size",
                                f"{2 * C1_W}x{2 * C1_H}",
                                "--superres-weights"], 8),
            ("train-videohdr", ["--hdr-passthrough", "--out-bits", "10",
                                "--videohdr-weights"], 10)):
        ckpt = os.path.join(tmp, f"{cmd}.npz")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_train = cli_main([cmd, "--out", ckpt, "--steps",
                                 str(CLI_TRAIN_STEPS), "--frames",
                                 str(CLI_TRAIN_FRAMES), "--batch",
                                 str(TRAIN_BATCH), "--patch",
                                 str(TRAIN_PATCH), "--device", dev.type])
        train_s = time.perf_counter() - t0
        result = json.loads(buf.getvalue().splitlines()[-1])
        sr = cmd == "train-superres"
        # the settings the CLI builds from these flags
        vr = VideoRenderer(cli_settings(vp_superres=SuperResolution.P1080)
                           if sr else Settings(convert_to_sdr=False,
                                               hdr_passthrough=True,
                                               vp_rtx_video_hdr=True),
                           device=dev)
        model = load_params(ckpt, sr_model.SuperRes() if sr
                            else vh_model.VideoHDR())
        (vr.set_superres_params if sr else vr.set_videohdr_params)(model)
        vr.open(src, OutputDescriptor(
            width=2 * C1_W if sr else C1_W, height=2 * C1_H if sr else C1_H,
            bits=bits, hdr=not sr))
        run, launches[cmd], _ = drive_process(
            dev, tmp, cmd, [clip, "--matrix", "BT_709", "--levels", "TV",
                            *flags, ckpt], vr, yuv, bits)
        runs[cmd] = {"rc_train": rc_train, "train_seconds": train_s,
                     "result": result,
                     "keys_equal_jax_cli": set(result) == TRAIN_KEYS[cmd],
                     **run}
        del vr, model
    line("train_cli", seconds=time.perf_counter() - t_phase,
         steps=CLI_TRAIN_STEPS, frames=CLI_TRAIN_FRAMES, runs=runs)
    if not all(r["rc_train"] == 0 and r["keys_equal_jax_cli"]
               and r["launches_equal_renderer"] and r["bit_equal_renderer"]
               and r["launches"].get("rows3_tail", 0)
               for r in runs.values()):
        raise AssertionError(f"train_cli: {runs}")
    return launches


def train_phases(dev) -> dict:
    """Phases 39-42: training at full width on the card (SuperRes, VideoHDR),
    data parallelism over a one-device mesh, and the command line's train
    commands.  Returns the launches of phase 42's process runs."""
    dev = torch.device(dev)
    sr = train_phase(dev, "train_sr")
    train_phase(dev, "train_hdr")
    dp_phase(dev, sr["frames"], sr["start"])
    with tempfile.TemporaryDirectory() as tmp:
        launches = train_cli_phase(dev, tmp)
    return {"launches": {f"train_cli_{k}": v for k, v in launches.items()}}


def checked_calls(calls, err) -> dict:
    """The recorded K1 and K3 calls of a path (``recording``) against their
    plain versions on the same inputs (K1 mid16 within 1 code, float32
    within 2e-5; K3 within 2e-6), with each K1 call's block rows and each
    K3 call's route; ``err(k, x)`` keeps the largest error per kernel."""
    out = {"k1_max_code_diff": 0, "k1_max_abs_err": 0.0,
           "k3_max_abs_err": 0.0, "k1_block_rows": [], "k3_routes": []}
    for args, kw, got in calls.get("banded_resize_last_axis", []):
        d = (got.float() - rk.banded_resize_last_axis_plain(*args, **kw)
             .float()).abs().max().item()
        if got.dtype == torch.int16:
            out["k1_max_code_diff"] = max(out["k1_max_code_diff"], int(d))
        else:
            out["k1_max_abs_err"] = max(out["k1_max_abs_err"], d)
            err("k1", d)
        out["k1_block_rows"].append(rk.k1_rows(
            args[0].element_size(), args[1].row_windows(rk.K1_SPAN)[1]))
    for args, kw, got in calls.get("banded_resize_rows", []):
        d = (got - rk.banded_resize_rows_plain(*args, **kw)).abs().max().item()
        out["k3_max_abs_err"] = max(out["k3_max_abs_err"], d)
        err("k3", d)
        out["k3_routes"].append("/".join(map(str, rk.k3_route(
            args[0].element_size(), args[1]))))
    if out["k1_max_code_diff"] > 1 or out["k1_max_abs_err"] > 2e-5 \
            or out["k3_max_abs_err"] > 2e-6:
        raise AssertionError(f"K1 or K3 disagrees with its plain version: "
                             f"{out}")
    return out


def spatial_call(fn, planes, err, expect: dict):
    """One call of a spatial function, counted from 0 and its K1 and K3
    calls held against their plain versions: (output, launches, checks)."""
    with recording(rk, "banded_resize_last_axis",
                   "banded_resize_rows") as calls:
        out, n = count_launches(lambda: fn(planes))
    if n != expect:
        raise AssertionError(f"spatial launches {n}, expected {expect}")
    return out, n, checked_calls(calls, err)


def k3_numbers(calls) -> dict:
    """K3's time, its plain version's, the library call's (one float32
    product a plane) and the bound over the recorded calls (args, kwargs,
    output), run together."""
    def run(f):
        return lambda: [f(*a, **kw) for a, kw, _ in calls]
    dense = [(a[1].dense_on(a[0].device).T, a[0].float()) for a, _, _ in calls]
    k = {"ms": cuda_ms(run(rk.banded_resize_rows)),
         "plain_ms": cuda_ms(run(rk.banded_resize_rows_plain)),
         "library_ms": cuda_ms(lambda: [torch.matmul(m, x)
                                        for m, x in dense])}
    k.update(bound(sum(tbytes(a[0], o) + mbytes(a[1]) for a, _, o in calls),
                   sum(map_flops(a[1], a[0].numel() // a[1].in_size)
                       for a, _, _ in calls)))
    return k


def spatial_phases(dev) -> dict:
    """Phases 43-48: parallel/spatial on the card.  43 (c6) and 45 (c9) on
    a one-rank NCCL mesh: K1 x3 + K3 x3 a call, each call against its plain
    version, bit-equal to the same function without a mesh, within K2's
    band of the unsharded make_frame_fn (K1 x3 + K2), >= 55 dB, ms/frame
    beside make_frame_fn's; 44: c6 as four shards one after another on the
    card (the halos cut from the other shards' blocks), each shard's own K3
    table, the stitched surface bit-equal to 43's; 46: the Dolby Vision
    form (c8's plan) and 47: the learned form (c3sr's plan, the shipped
    SuperRes) on the mesh and as four shards, each against its unsharded
    counterpart; 48: the Jinc2 form on the mesh and as four shards, c3's
    plan (K6) bit-equal to the unsharded K6, c3 letterboxed (stage A, K5 on
    each shard's band, the torch tail) bit-equal to one shard and within
    K2's band of the unsharded K1 x2 + K2 + K5.  Returns
    the phases' launches, the kernels' errors and K3's per-shard numbers."""
    dev = torch.device(dev)
    res = {"launches": {}, "err": {k: 0.0 for k in ("k1", "k3", "k5")}}

    def err(k, x):
        res["err"][k] = max(res["err"][k], float(x))

    six = only(banded_resize_last_axis=3, banded_resize_rows=3)
    mesh = make_mesh(axis="spatial", device=dev)
    try:
        # 43. c6: the headline's plan (build_plan("c6"), bench_common:210),
        #     packed, at input_spec's batch of 32
        src, dst = headline_args()
        plan6 = plan_pipeline(headline_settings(True), src, dst)
        b6 = p010_batch(C6_BATCH, SEED + 100, dev)
        fn6 = sp.make_spatial_frame_fn(plan6, mesh, pack_surface=True)
        sh6 = sp.shard_planes_rows(mesh, b6)
        out6, n6, k6 = spatial_call(fn6, sh6, err, six)
        res["launches"]["c6"] = n6
        bare = sp.make_spatial_frame_fn(plan6, sp.Shard(0, 1),
                                        pack_surface=True)(b6)
        frame6 = make_frame_fn(plan6, pack_surface=True)
        ref6, n_ref = count_launches(lambda: frame6(b6))
        if n_ref != only(banded_resize_last_axis=3, rows3_tail=1):
            raise AssertionError(f"c6 unsharded launches {n_ref}")
        c6 = {"bit_equal_no_mesh": bool(torch.equal(out6, bare)),
              "unsharded": code_diff(out6, ref6, 10),
              "psnr_db": psnr(codes(out6[0], 10).double() / 1023.0,
                              oracle(*(p[0] for p in b6), OW, OH)),
              "ms_per_frame": cuda_ms(lambda: fn6(sh6), reps=3) / C6_BATCH,
              "frame_fn_ms_per_frame": cuda_ms(lambda: frame6(b6),
                                               reps=3) / C6_BATCH,
              "digest": digest(out6)}
        del bare, ref6
        u = c6["unsharded"]
        if not c6["bit_equal_no_mesh"] or u["max_code_diff"] > 1 \
                or u["frac_differing"] >= 0.02 or c6["psnr_db"] < 55.0:
            raise AssertionError(f"c6: {c6}")
        line("c6", batch=C6_BATCH, mesh_ranks=mesh.size, launches=n6,
             kernels=k6, tolerance="K1 mid16 <= 1 code, f32 <= 2e-5; K3 <= "
             "2e-6; the unsharded plan <= 1 code on < 2% of channels", **c6)

        # 44. four shards of c6 on the card, one after another, no
        #     collective: each shard's K3 runs its own table
        with recording(rk, "banded_resize_rows") as calls:
            outs4, n4 = count_launches(lambda: sp.drive_shards_locally(
                lambda sh: sp.make_spatial_frame_fn(plan6, sh,
                                                    pack_surface=True),
                lambda r: sp.shard_planes_rows(sp.Shard(r, SHARDS), b6),
                SHARDS))
        passes = n4["banded_resize_rows"] // (3 * SHARDS)
        if n4 != only(banded_resize_last_axis=3 * SHARDS * passes,
                      banded_resize_rows=3 * SHARDS * passes) or passes != 2:
            raise AssertionError(f"c6 x{SHARDS}: launches {n4}")
        settled = calls["banded_resize_rows"][-3 * SHARDS:]
        del calls
        shards = []
        for r in range(SHARDS):
            mine = settled[3 * r:3 * r + 3]
            e = max((o - rk.banded_resize_rows_plain(*a, **kw)).abs().max()
                    .item() for a, kw, o in mine)
            err("k3", e)
            shards.append({
                "rank": r, "k3_max_abs_err": e,
                "k3_routes": ["/".join(map(str, rk.k3_route(
                    a[0].element_size(), a[1]))) for a, _, _ in mine],
                "k3_in_rows": [a[0].shape[-2] for a, _, _ in mine],
                "k3_out_rows": [o.shape[-2] for _, _, o in mine],
                # a call's input: the shard's rows of its plane + 2 halos
                "halo_rows": [(a[0].shape[-2] - p.shape[-2] // SHARDS) // 2
                              for (a, _, _), p in zip(mine, b6)]})
        # the per-shard K3 numbers: rank 1's three calls (an inner shard)
        k3s = k3_numbers(settled[3:6])
        k3s["max_abs_err"] = max(d["k3_max_abs_err"] for d in shards)
        k3s["route"] = shards[1]["k3_routes"][0]
        del settled
        whole = torch.cat(outs4, dim=-2)
        c6x = {"bit_equal_one_shard": bool(torch.equal(whole, out6)),
               "passes": passes, "digest": digest(whole)}
        del outs4, whole
        if not c6x["bit_equal_one_shard"] or k3s["max_abs_err"] > 2e-6:
            raise AssertionError(f"c6 x{SHARDS}: {c6x}, K3 {k3s}")
        res["launches"][f"c6x{SHARDS}"] = n4
        res["k3_shard"] = k3s
        line(f"c6x{SHARDS}", batch=C6_BATCH, shards=shards, launches=n4,
             k3_per_shard=k3s, tolerance="bit-equal to c6's surface; K3 <= "
             "2e-6", **c6x)
        del out6, b6, sh6, fn6, frame6
        torch.cuda.empty_cache()

        # 45. c9: 8K P010 PQ -> 4K RGB10 (bench_common:229-236), float out
        #     as bench runs it, batch 4
        src9 = SourceDescriptor(format=ColorFormat.P010, width=C9_W,
                                height=C9_H, matrix=CSP.BT_2020_NC,
                                levels=Levels.TV, primaries=Primaries.BT_2020,
                                transfer=TRC.PQ, hdr10=HDR10Metadata())
        plan9 = plan_pipeline(headline_settings(True), src9,
                              OutputDescriptor(width=C9_OW, height=C9_OH,
                                               bits=10))
        b9 = p010_frames(C9_BATCH, SEED + 101, dev, C9_W, C9_H)
        fn9 = sp.make_spatial_frame_fn(plan9, mesh)
        sh9 = sp.shard_planes_rows(mesh, b9)
        out9, n9, k9 = spatial_call(fn9, sh9, err, six)
        res["launches"]["c9"] = n9
        bare = sp.make_spatial_frame_fn(plan9, sp.Shard(0, 1))(b9)
        frame9 = make_frame_fn(plan9)
        with recording(rk, "rows3_tail") as k2calls:
            ref9, n_ref = count_launches(lambda: frame9(b9))
        a2 = k2calls["rows3_tail"][0][0]
        del k2calls
        if n_ref != only(banded_resize_last_axis=3, rows3_tail=1):
            raise AssertionError(f"c9 unsharded launches {n_ref}")
        c9 = {"bit_equal_no_mesh": bool(torch.equal(out9, bare)),
              "unsharded": float_code_diff(out9, ref9, 1023),
              "unsharded_k2_route": rk.k2_route(
                  a2[0].element_size(), a2[1].element_size(), a2[3], a2[4]),
              "psnr_db": psnr(out9[0].double(), oracle(
                  *(p[0] for p in b9), C9_OW, C9_OH)),
              "ms_per_frame": cuda_ms(lambda: fn9(sh9), reps=3) / C9_BATCH,
              "frame_fn_ms_per_frame": cuda_ms(lambda: frame9(b9),
                                               reps=3) / C9_BATCH,
              "digest": digest(out9)}
        del bare, ref9, a2
        u = c9["unsharded"]
        if not c9["bit_equal_no_mesh"] or u["max_code_diff"] > 1 \
                or u["frac_differing"] >= 0.02 or c9["psnr_db"] < 55.0:
            raise AssertionError(f"c9: {c9}")
        line("c9", batch=C9_BATCH, mesh_ranks=mesh.size, launches=n9,
             kernels=k9, tolerance="as c6", **c9)
        del out9, b9, sh9, fn9, frame9
        torch.cuda.empty_cache()

        # 46. the Dolby Vision form: c8's plan on the mesh, stage A (K1 on
        #     the chroma, K3 on the chroma's upsample) and stage B (K1 and
        #     K3 on the PQ RGB), against the unsharded K1 x2 + K8 + K9
        meta = dovi_meta()
        plan8 = plan_pipeline(*c8_args(meta))
        b8 = p010_batch(BATCH, SEED + 102, dev)
        fn8 = sp.make_spatial_frame_fn(plan8, mesh, pack_surface=True)
        sh8 = sp.shard_planes_rows(mesh, b8)
        out8, n8, kd = spatial_call(fn8, sh8, err, only(
            banded_resize_last_axis=3, banded_resize_rows=3))
        res["launches"]["spatial_dovi"] = n8
        ref8, n_ref = count_launches(
            lambda: make_frame_fn(plan8, pack_surface=True)(b8))
        if n_ref != only(banded_resize_last_axis=2, rows3_mid=1,
                         cols3_tail=1):
            raise AssertionError(f"c8 unsharded launches {n_ref}")
        dd = (codes(out8, 10) - codes(ref8, 10)).abs().double() / 1023.0
        d8 = {"unsharded": {"max_abs_diff": dd.max().item(),
                            "frac_over_half_8bit_code": (
                                dd > 0.5 / 255).double().mean().item(),
                            **code_diff(out8, ref8, 10)},
              "psnr_db": psnr(codes(out8[0], 10).double() / 1023.0,
                              c8_oracle(b8, meta, dovi_rt(0))),
              "ms_per_frame": cuda_ms(lambda: fn8(sh8), reps=3) / BATCH,
              "digest": digest(out8)}
        del out8, ref8, b8, sh8, fn8, dd
        u = d8["unsharded"]
        if u["max_abs_diff"] > 1.5 / 255 \
                or u["frac_over_half_8bit_code"] >= 1e-3 \
                or d8["psnr_db"] < 55.0:
            raise AssertionError(f"spatial DoVi: {d8}")
        # the JAX package's band between its spatial and one-device DoVi
        # forms (tests/test_spatial.py:329-330): the two forms resize in
        # other orders around the PQ -> SDR chain
        line("spatial_dovi", batch=BATCH, launches=n8, kernels=kd,
             tolerance="the unsharded K1 x2 + K8 + K9 within 1.5/255, over "
             "0.5/255 on < 1e-3 of channels", **d8)

        # 47. the learned form: c3sr's plan (the 1:1 convert, bench_common
        #     :188-192) and the shipped SuperRes on the mesh, against the net
        #     on the unsharded frame function's output
        src_sr = SourceDescriptor(format=ColorFormat.NV12, width=C1_W,
                                  height=C1_H, matrix=CSP.BT_709,
                                  levels=Levels.TV)
        plan_sr = plan_pipeline(Settings(vp_superres=SuperResolution.P1080),
                                src_sr, OutputDescriptor(width=C1_W,
                                                         height=C1_H, bits=8))
        model = real_eval.load_shipped_superres(dev)
        bsr = nv12_batch(SR_BATCH, SEED + 103, dev)
        fnsr = sp.make_spatial_learned_fn(plan_sr, mesh, model, "superres",
                                          pack_surface=True)
        shsr = sp.shard_planes_rows(mesh, bsr)
        outsr, nsr, ksr = spatial_call(fnsr, shsr, err, only(
            banded_resize_last_axis=2, banded_resize_rows=2))
        res["launches"]["spatial_sr"] = nsr
        refsr = rk.pack_surface(sr_model.enhance_plane_chw(
            model, make_frame_fn(plan_sr)(bsr)), "rgba8")
        dsr = {"unsharded": code_diff(outsr, refsr, 8),
               "unsharded_psnr_db": psnr(codes(outsr, 8).double() / 255.0,
                                         codes(refsr, 8).double() / 255.0),
               "halo_rows": sp.model_receptive_radius_s2d(model)
               * model.cfg.s2d,
               "ms_per_frame": cuda_ms(lambda: fnsr(shsr), reps=3) / SR_BATCH,
               "digest": digest(outsr)}
        # four shards of it on the card, one after another: each shard's
        # halo rows (zeroed outside the frame, row_valid), the s2d unit's
        # mesh pad (1080 -> 1088 rows), the crop
        with recording(rk, "banded_resize_rows") as calls:
            outs4, nsr4 = count_launches(lambda: sp.drive_shards_locally(
                lambda sh: sp.make_spatial_learned_fn(
                    plan_sr, sh, model, "superres", pack_surface=True),
                lambda r: sp.shard_planes_rows(sp.Shard(r, SHARDS), bsr),
                SHARDS))
        passes = nsr4["banded_resize_last_axis"] // (2 * SHARDS)
        k3_per = nsr4["banded_resize_rows"] // (SHARDS * passes)
        if nsr4 != only(banded_resize_last_axis=2 * SHARDS * passes,
                        banded_resize_rows=k3_per * SHARDS * passes):
            raise AssertionError(f"spatial SuperRes x{SHARDS}: {nsr4}")
        for a, kw, o in calls["banded_resize_rows"]:
            err("k3", (o - rk.banded_resize_rows_plain(*a, **kw)).abs().max()
                .item())
        del calls
        whole = torch.cat(outs4, dim=-2)[..., :outsr.shape[-2], :]
        dsr.update({
            "x4_passes": passes, "x4_k3_per_shard_call": k3_per,
            "x4_bit_equal_one_shard": bool(torch.equal(whole, outsr)),
            "x4_one_shard": code_diff(whole, outsr, 8),
            "x4_unsharded_psnr_db": psnr(codes(whole, 8).double() / 255.0,
                                         codes(refsr, 8).double() / 255.0),
            "x4_digest": digest(whole)})
        res["launches"][f"spatial_srx{SHARDS}"] = nsr4
        del outs4, whole, outsr, refsr, bsr, shsr, fnsr, model
        if dsr["unsharded_psnr_db"] < 50.0 \
                or not dsr["x4_bit_equal_one_shard"]:
            raise AssertionError(f"spatial SuperRes: {dsr}")
        line("spatial_sr", batch=SR_BATCH, launches=nsr, kernels=ksr,
             shard_launches=nsr4, tolerance="the unsharded composition >= "
             "50 dB; four shards bit-equal to one", **dsr)

        # 48. the Jinc2 form: c3's plan (1080p NV12 -> 4K Jinc2, RGBA8,
        #     bench_common:177-187) on the mesh and as four shards on the
        #     card, one K6 launch on each shard's band of rows
        plan3 = plan_pipeline(*c3_args())
        b3 = nv12_batch(BATCH, SEED + 104, dev)
        fn3 = sp.make_spatial_frame_fn(plan3, mesh, pack_surface=True)
        sh3 = sp.shard_planes_rows(mesh, b3)
        frame3 = make_frame_fn(plan3, pack_surface=True)
        frame3(b3)          # builds the geometry's weight table if dropped
        ref3, n_ref = count_launches(lambda: frame3(b3))
        out3, n3 = count_launches(lambda: fn3(sh3))
        outs3, n34 = count_launches(lambda: sp.drive_shards_locally(
            lambda sh: sp.make_spatial_frame_fn(plan3, sh, pack_surface=True),
            lambda r: sp.shard_planes_rows(sp.Shard(r, SHARDS), b3), SHARDS))
        k6 = only(jinc2_convert_fused=1)
        if n_ref != k6 or n3 != k6 \
                or n34 != only(jinc2_convert_fused=2 * SHARDS):
            raise AssertionError(f"spatial c3 launches {n_ref}, {n3}, {n34}")
        res["launches"]["spatial_c3"] = n3
        res["launches"][f"spatial_c3x{SHARDS}"] = n34
        j3 = {"bit_equal_unsharded_k6": bool(torch.equal(out3, ref3)),
              f"x{SHARDS}_bit_equal_unsharded_k6": bool(torch.equal(
                  torch.cat(outs3, dim=-2), ref3)),
              "psnr_db": psnr(codes(out3[0], 8).double() / 255.0,
                              oracle_jinc2(b3[0][0], b3[1][0], b3[2][0],
                                           C3_OW, C3_OH)),
              "ms_per_frame": cuda_ms(lambda: fn3(sh3), reps=3) / BATCH,
              "frame_fn_ms_per_frame": cuda_ms(lambda: frame3(b3),
                                               reps=3) / BATCH,
              "digest": digest(out3)}
        del out3, outs3, ref3, fn3, frame3
        if not (j3["bit_equal_unsharded_k6"]
                and j3[f"x{SHARDS}_bit_equal_unsharded_k6"]) \
                or j3["psnr_db"] < 55.0:
            raise AssertionError(f"spatial c3: {j3}")
        line("spatial_c3", batch=BATCH, launches=n3,
             shard_launches=n34, tolerance="bit-equal to the unsharded K6",
             **j3)

        # c3 letterboxed into the 4K surface (J3_RECT): the K5 route, stage
        # A (K1 x2, K3 x2, the matrix in torch), K5 on each shard's band of
        # rows, the torch tail; against the unsharded K1 x2 + K2 + K5
        st3, src3, dst3 = c3_args()
        plan3p = plan_pipeline(st3, src3, dataclasses.replace(
            dst3, video_rect=J3_RECT))
        l, t, r, b = J3_RECT
        fn3p = sp.make_spatial_frame_fn(plan3p, mesh, pack_surface=True)
        fn3p(sh3)           # builds the geometry's weight table if dropped
        with recording(jk, "jinc2_resize_fused") as k5calls:
            out3p, n3p, k3p = spatial_call(fn3p, sh3, err, only(
                banded_resize_last_axis=2, banded_resize_rows=2,
                jinc2_resize_fused=1))
        (a5, kw5, got5), = k5calls["jinc2_resize_fused"]
        e5 = (got5 - jk.jinc2_resize_fused_plain(*a5, **kw5)).abs().max()
        k3p.update({"k5_max_abs_err": e5.item(), "k5_route": "/".join(
            jk.k5_route(a5[0].shape[-2], a5[0].shape[-1], a5[1], a5[2],
                        kw5.get("rows")))})
        err("k5", k3p["k5_max_abs_err"])
        del k5calls, a5, kw5, got5, e5
        frame3p = make_frame_fn(plan3p, pack_surface=True)
        ref3p, n_ref = count_launches(lambda: frame3p(b3))
        if n_ref != only(banded_resize_last_axis=2, rows3_tail=1,
                         jinc2_resize_fused=1):
            raise AssertionError(f"c3 letterboxed unsharded launches {n_ref}")
        outs3p, n3p4 = count_launches(lambda: sp.drive_shards_locally(
            lambda sh: sp.make_spatial_frame_fn(plan3p, sh,
                                                pack_surface=True),
            lambda r: sp.shard_planes_rows(sp.Shard(r, SHARDS), b3), SHARDS))
        passes = n3p4["jinc2_resize_fused"] // SHARDS
        if n3p4 != only(banded_resize_last_axis=2 * SHARDS * passes,
                        banded_resize_rows=2 * SHARDS * passes,
                        jinc2_resize_fused=SHARDS * passes):
            raise AssertionError(f"c3 letterboxed x{SHARDS}: {n3p4}")
        res["launches"]["spatial_c3_placed"] = n3p
        res["launches"][f"spatial_c3_placedx{SHARDS}"] = n3p4
        bars = torch.cat([out3p[..., :t, :], out3p[..., b:, :]], dim=-2)
        j3p = {"x4_bit_equal_one_shard": bool(torch.equal(
                   torch.cat(outs3p, dim=-2), out3p)),
               "x4_passes": passes,
               "unsharded": code_diff(out3p, ref3p, 8),
               "bars_packed_zero": bool(
                   (bars == rk.PACKED_ZERO["rgba8"]).all().item()),
               "psnr_db": psnr(codes(out3p[0, t:b], 8).double() / 255.0,
                               oracle_jinc2(b3[0][0], b3[1][0], b3[2][0],
                                            r - l, b - t)),
               "ms_per_frame": cuda_ms(lambda: fn3p(sh3), reps=3) / BATCH,
               "frame_fn_ms_per_frame": cuda_ms(lambda: frame3p(b3),
                                                reps=3) / BATCH,
               "digest": digest(out3p)}
        del out3p, outs3p, ref3p, bars, b3, sh3, fn3p, frame3p
        u = j3p["unsharded"]
        if not (j3p["x4_bit_equal_one_shard"] and j3p["bars_packed_zero"]) \
                or u["max_code_diff"] > 1 or u["frac_differing"] >= 0.02 \
                or j3p["psnr_db"] < 55.0 or k3p["k5_max_abs_err"] > 1e-5:
            raise AssertionError(f"spatial c3 letterboxed: {j3p}")
        line("spatial_c3_placed", batch=BATCH, rect=J3_RECT, launches=n3p,
             kernels=k3p, shard_launches=n3p4, tolerance="four shards "
             "bit-equal to one; K5 <= 1e-5 of its plain version; the "
             "unsharded plan <= 1 code on < 2% of channels", **j3p)
    finally:
        mesh.destroy()
    torch.cuda.empty_cache()
    return res


def coverage_phases(dev) -> dict:
    """Phases 49-50: c2 (4K P010 -> 1080p RGB10, Catmull-Rom up and Hamming
    down, bench_common:171-176) and c4 (the 4K tone map 1:1 to RGB8,
    :200-204) through VideoProcessor: launches, each kernel's call against
    its plain version, >= 55 dB, ms/frame."""
    dev = torch.device(dev)
    res = {"launches": {}, "err": {k: 0.0 for k in ("k1", "k2", "k3")}}

    def err(k, x):
        res["err"][k] = max(res["err"][k], float(x))

    src, dst = headline_args()
    cases = {
        "c2": (Settings(upscaling=Upscaling.CATMULL_ROM,
                        downscaling=Downscaling.HAMMING), dst,
               dict(upscaling=Upscaling.CATMULL_ROM,
                    downscaling=Downscaling.HAMMING), 3),
        "c4": (Settings(convert_to_sdr=True),
               OutputDescriptor(width=W, height=H, bits=8),
               dict(dither_bits=8), 2)}
    for i, (key, (settings, out, okw, n_k1)) in enumerate(cases.items()):
        src_k = (src if key == "c2" else dataclasses.replace(
            src, hdr10=HDR10Metadata(max_cll=4000, max_fall=1000)))
        vp = VideoProcessor(settings, src_k, out, device=dev,
                            pack_surface=True)
        bits = out.bits
        batches = [p010_batch(BATCH, SEED + 110 + 2 * i + j, dev)
                   for j in range(2)]
        two = tuple(p[:PLAIN_FRAMES] for p in batches[0])
        with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
            vp.process(two)
        torch.cuda.synchronize()
        chk = checked_calls(calls, err)
        (a2, kw2, got2), = calls["rows3_tail"]
        k2 = code_diff(got2, rk.rows3_tail_plain(*a2, **kw2), bits)
        err("k2", k2["max_code_diff"] / (2 ** bits - 1))
        del calls, a2, kw2, got2
        outs, n = count_launches(lambda: [vp.process(b) for b in batches])
        res["launches"][key] = n
        db = psnr(codes(outs[0][0], bits).double() / (2 ** bits - 1),
                  oracle(*(p[0] for p in batches[0]), out.width, out.height,
                         **okw))
        ck = {"launches": n, "psnr_db": db, "k1": chk, "k2": k2,
              "ms_per_frame": timed_calls(vp.process, batches),
              "digest": digest(*outs)}
        del outs, batches, vp
        if n != only(banded_resize_last_axis=2 * n_k1, rows3_tail=2) \
                or k2["max_code_diff"] > 1 or k2["frac_differing"] >= 0.02 \
                or db < 55.0:
            raise AssertionError(f"{key}: {ck}")
        line(key, batch=BATCH, kernels_frames=PLAIN_FRAMES,
             tolerance="K1 mid16 <= 1 code, f32 <= 2e-5; K2 <= 1 code on "
             "< 2% of channels", **ck)
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def dovi_mid_setting(value: str):
    """``VRT_TPU_DOVI_MID`` at ``value`` inside the block (the Dolby Vision
    functions read it at every call), as it was after the block."""
    old = os.environ.get("VRT_TPU_DOVI_MID")
    os.environ["VRT_TPU_DOVI_MID"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["VRT_TPU_DOVI_MID"]
        else:
            os.environ["VRT_TPU_DOVI_MID"] = old


NEAR_BLACK = 32   # 10-bit codes where the SDR gamma's slope passes ~30


def chain_diff(outs, others, bits: int) -> dict:
    """Two routes' surfaces (lists of packed dwords) channel by channel:
    the largest code difference and the share of channels that differ, and
    the channels more than 1 code apart: their share and the largest code
    either route gives them.  Near black the SDR gamma's slope amplifies a
    float32 rounding step of the PQ signal into several codes, so two
    routes that sum their taps in other orders part there; elsewhere they
    stay within 1 code."""
    n = over = differing = 0
    out = {"max_code_diff": 0, "frac_differing": 0.0, "frac_over_1": 0.0,
           "over_1_max_code": 0}
    for o, o1 in zip(outs, others):
        ca, cb = codes(o, bits), codes(o1, bits)
        d = (ca - cb).abs()
        n += d.numel()
        differing += int((d > 0).sum().item())
        big = d > 1
        over += int(big.sum().item())
        out["max_code_diff"] = max(out["max_code_diff"], int(d.max().item()))
        if big.any():
            out["over_1_max_code"] = max(out["over_1_max_code"], int(
                torch.maximum(ca[big], cb[big]).max().item()))
    out["frac_differing"] = differing / n
    out["frac_over_1"] = over / n
    return out


def two_stage_phase(dev) -> dict:
    """Phase 51: c8 through the two-stage Dolby Vision form
    (VRT_TPU_DOVI_MID=0): K1 x2 on the chroma, K2's Dolby Vision route
    (stage A, the H upsample and the convert at source resolution), K1 x3
    on R, G, B and K2 (stage B) a call.  c8's four scenes, the variant
    where nothing folds (stage A's LMS route), c8x (the L2 trims: stage B
    on K2's extended runtime route) and c8 in C8_RECT (stage B's offset
    store), through make_serving_fn at batch 16: each call's kernels on
    PLAIN_FRAMES frames against their plain versions (stage A within 1e-5,
    1e-4 with the LMS step; K1 float32 within 2e-5; K2 within 1 code on
    < 2%), the launch counts, no build between scenes, >= 55 dB against
    oracle_dovi, the surface against the one-intermediate chain's (K1 x2 +
    K8 + K9, the same function with the switch at "1") by
    :func:`chain_diff`, the bars the packed zero; ms/frame of both forms; stage A's time at
    batch 16 with its plain version's and its bound."""
    dev = torch.device(dev)
    res = {"launches": {}, "err": {"k1": 0.0, "k2": 0.0, "k2_dovi": 0.0}}

    def err(k, x):
        res["err"][k] = max(res["err"][k], float(x))

    meta, variant = dovi_meta(), dovi_variant()
    ext_args = c8ext_args(False)
    st8, src8, _ = c8_args(meta)
    exts = [dovi_extensions(i) for i in range(HDR_SCENES)]
    cases = {
        "c8": (c8_args(meta), meta, [{"dovi_curves": dovi_rt(i)}
                                     for i in range(C8_SCENES)], None, 1e-5),
        "variant": (c8_args(variant), variant,
                    [{"dovi_curves": dovi_rt(1, variant)}], None, 1e-4),
        "c8x": (ext_args, meta, [
            {"dovi_curves": dovi_rt(i), "l2_trims":
             dovi_ext.runtime_trims_from_extensions(e, 100.0)}
            for i, e in enumerate(exts)], None, 1e-5),
        "c8_rect": ((st8, src8, OutputDescriptor(
            width=OW, height=OH, bits=10, video_rect=C8_RECT)), meta,
            [{"dovi_curves": dovi_rt(i)} for i in range(C8_SCENES)],
            C8_RECT, 1e-5)}
    cells = {}
    with dovi_mid_setting("0"):
        for k, (name, (args, m, rts, rect, tol)) in enumerate(cases.items()):
            n_sc = len(rts)
            serve = make_serving_fn(plan_pipeline(*args), pack_surface=True)
            bs = [p010_batch(BATCH, SEED + 140 + 10 * k + i, dev)
                  for i in range(n_sc)]
            # the path's kernels on PLAIN_FRAMES frames
            with recording(rk, "banded_resize_last_axis", "rows3_tail_dovi",
                           "rows3_tail") as calls:
                serve(tuple(p[:PLAIN_FRAMES] for p in bs[0]), rts[0])
            torch.cuda.synchronize()
            chk = checked_calls(calls, err)
            (aa, kwa, gota), = calls["rows3_tail_dovi"]
            (ab, kwb, gotb), = calls["rows3_tail"]
            ea = (gota - rk.rows3_tail_dovi_plain(*aa, **kwa)).abs().max()
            ea = ea.item()
            d2 = code_diff(gotb, rk.rows3_tail_plain(*ab, **kwb), 10)
            err("k2_dovi", ea)
            err("k2", d2["max_code_diff"] / 1023.0)
            kern = {"stage_a_max_abs_err": ea, "stage_b_k2": d2,
                    "k1_max_abs_err": chk["k1_max_abs_err"],
                    "stage_a_route": dk.rows3_mid_route(aa[0].dtype,
                                                        aa[1].dtype, aa[6]),
                    "stage_b_route": rk.rows3_tail_route(
                        ab[0].dtype, ab[1].dtype, ab[6],
                        kwb.get("pack_format")),
                    "stage_a_digest": digest(gota)}
            del calls, aa, kwa, gota, ab, kwb, gotb
            if ea > tol or d2["max_code_diff"] > 1 \
                    or d2["frac_differing"] >= 0.02:
                raise AssertionError(f"c8_two_stage {name}: a kernel "
                                     f"disagrees with its plain version: "
                                     f"{kern}")
            # stage A at batch 16 (also the warm-up)
            with recording(rk, "rows3_tail_dovi") as calls:
                serve(bs[0], rts[0])
            torch.cuda.synchronize()
            (aa, kwa, _), = calls["rows3_tail_dovi"]
            del calls
            outs, n, times = serve_counted(serve, bs, rts, only(
                banded_resize_last_axis=5 * n_sc, rows3_tail_dovi=n_sc,
                rows3_tail=n_sc))
            res["launches"][name] = n
            for o in outs:
                if o.shape != (BATCH, OH, OW) or o.dtype != torch.int32:
                    raise AssertionError(f"c8_two_stage {name} output "
                                         f"{tuple(o.shape)} {o.dtype}")

            def want(i):
                rt = rts[i]
                return oracle_dovi(
                    *(p[0] for p in bs[i]), OW, OH, curves=rt["dovi_curves"],
                    structure=dovi.curve_structure(m),
                    ycc_to_rgb=m.ycc_to_rgb_matrix,
                    ycc_offset=m.ycc_to_rgb_offset,
                    lms=dovi.lms_pipeline_matrix(m), video_rect=rect,
                    trims=trim_list(rt) if "l2_trims" in rt else None)

            db = {f"scene{i}": psnr(codes(outs[i][0], 10).double() / 1023.0,
                                    want(i)) for i in sorted({0, n_sc - 1})}
            with dovi_mid_setting("1"):
                ones = [serve(b, rt) for b, rt in zip(bs, rts)]
            vs_one = chain_diff(outs, ones, 10)
            del ones
            placed = {}
            if rect is not None:
                l, tp, r, bt = rect
                mask = torch.ones((OH, OW), dtype=torch.bool, device=dev)
                mask[tp:bt, l:r] = False
                placed = {"rect": list(rect), "bars_black": all(
                    bool(torch.all(o[..., mask]
                                   == rk.PACKED_ZERO["rgb10a2"]).item())
                    for o in outs)}
            out_digest = digest(*outs)
            del outs

            def run():
                return [serve(b, rt) for b, rt in zip(bs, rts)]

            ms = cuda_ms(run, reps=1, warmup=0) / (n_sc * BATCH)
            with dovi_mid_setting("1"):
                ms_one = cuda_ms(run, reps=1) / (n_sc * BATCH)
            # stage A: the luma and chroma read once, three float32 planes
            # written, the maps' tap tables; operations: the H taps and the
            # identity convert (4 a channel's reshape, 18 the matrix)
            h_a, w_a = aa[0].shape[-2:]
            frames = aa[0].numel() // (h_a * w_a)
            k2a = {"ms": cuda_ms(lambda: rk.rows3_tail_dovi(*aa, **kwa))}
            k2a.update(bound(
                tbytes(*aa[:3]) + 3 * frames * h_a * w_a * 4
                + mbytes(aa[3], aa[4]),
                map_flops(aa[3], frames * w_a)
                + 2 * map_flops(aa[4], frames * w_a)
                + 30 * frames * h_a * w_a), library_ms=None)
            if name == "c8":
                k2a["plain_ms"] = cuda_ms(
                    lambda: rk.rows3_tail_dovi_plain(*aa, **kwa), reps=1)
                res["k2_dovi"] = k2a
            del aa, kwa, bs, serve
            torch.cuda.empty_cache()
            cell = {"launches": n, "psnr_db": db, "ms_per_frame": ms,
                    "ms_per_frame_synced": sum(times) / (n_sc * BATCH),
                    "mid_chain_ms_per_frame": ms_one,
                    "stage_a_ms": k2a["ms"],
                    "stage_a_bound_ms": k2a["bound_ms"],
                    "stage_a_bound_by": k2a["bound_by"],
                    "vs_mid_chain": vs_one, "kernels": kern,
                    "digest": out_digest, **placed}
            cells[name] = cell
            if n != only(banded_resize_last_axis=5 * n_sc,
                         rows3_tail_dovi=n_sc, rows3_tail=n_sc) \
                    or min(db.values()) < 55.0 \
                    or vs_one["frac_differing"] >= 0.02 \
                    or vs_one["frac_over_1"] >= 1e-5 \
                    or vs_one["over_1_max_code"] >= NEAR_BLACK \
                    or (rect is not None and not placed["bars_black"]):
                raise AssertionError(f"c8_two_stage {name}: {cell}")
    line("c8_two_stage", batch=BATCH, kernels_frames=PLAIN_FRAMES,
         switch="VRT_TPU_DOVI_MID=0", stage_a_plain_ms=res["k2_dovi"][
             "plain_ms"],
         tolerance="stage A <= 1e-5 (variant 1e-4); K1 f32 <= 2e-5; K2 <= 1 "
                   "code on < 2% of channels; the one-intermediate chain: "
                   "differing on < 2% of channels, over 1 code on < 1e-5 "
                   "and only below code 32 (near black); >= 55 dB",
         **cells)
    return res


def k4_phase(dev) -> tuple[dict, dict]:
    """Phase 19: K4 (see the module's docstring); returns the headline
    case's numbers (ms, plain_ms, bound; max_abs_err the worst case's) and
    the launches of the counted run."""
    # 19. K4 on the fused plans' own maps and tails: the headline (2:1
    #     Lanczos3, PQ -> SDR, 10-bit dither), c7 (1:1, the chroma
    #     upsample, BT.2390 with scene 2's values) and the headline source
    #     to a 160 x 90 Lanczos thumbnail (the long-window route).  On
    #     PLAIN_FRAMES frames against mega3_tail_plain, against the
    #     two-stage route with float32 intermediates (TexFormat.FLOAT16: K1
    #     then K2, unpacked), and with the colour matrix only against the
    #     plain version; the long-window route forced, bit-equal to the
    #     staged one; then at batch 16, one launch a call counted, timed on
    #     each route and at each staged tile height beside the two-stage
    #     route (mid16, as the main path runs it: unpacked like K4, and
    #     packed) on the same inputs
    scene2 = c7_rt(2)
    k4_cases, k4_runs = {}, []
    for key, args, f16_args, rt, seed in (
            ("headline", (headline_settings(True), *headline_args()),
             (headline_settings(True, TexFormat.FLOAT16), *headline_args()),
             None, SEED + 40),
            ("c7", c7_args(), c7_args(tex_format=TexFormat.FLOAT16), scene2,
             SEED + 41),
            ("thumb", thumb_k4_args(), thumb_k4_args(TexFormat.FLOAT16),
             None, SEED + 42))[:3 if K4_ROUTES else 2]:
        p = plan_pipeline(*args)
        mx_y, my_y, mx_c, my_c, nrm = fused_maps(p)
        (ky, hy), (kc, hc) = (rk.mega_maps(mx_y, my_y, nrm),
                              rk.mega_maps(mx_c, my_c, nrm))
        oh, ow = p.dst.video_size[1], p.dst.video_size[0]
        maps = (ky, kc, hy, hc, oh)
        epi = _make_tail_epilogue(
            p, rt=None if rt is None else {"hdr": rt["hdr"]})
        b16 = p010_batch(BATCH, seed, dev)
        two = tuple(q[:PLAIN_FRAMES] for q in b16)
        got = rk.mega3_tail(*two, *maps, epi, nrm)
        torch.cuda.synchronize()
        c = {"vs_plain": float_code_diff(
            got, rk.mega3_tail_plain(*two, *maps, epi, nrm), 1023),
             "digest": digest(got)}
        long_window = False
        if K4_ROUTES:
            route = rk.k4_route(2, 2, ky, kc, hy, hc)
            long_window = route[0] == "long-window"
            if long_window != (key == "thumb"):
                raise AssertionError(f"K4 {key}: route {route}")
            c["k4_route"] = list(route)
            c["route"] = rk.mega3_tail_route(b16[0].dtype, b16[1].dtype, epi,
                                             long_window)
        if K4_ROUTES and not long_window:
            c["long_window_bit_equal"] = torch.equal(got, forced_long(
                rk, "K4_LONG_WINDOW",
                lambda: rk.mega3_tail(*two, *maps, epi, nrm)))
        f16 = make_serving_fn(plan_pipeline(*f16_args))
        ts_out, ts_launches = count_launches(lambda: f16(two, rt))
        if ts_launches != only(banded_resize_last_axis=3 if mx_y is not None
                               else 2, rows3_tail=1):
            raise AssertionError(f"K4 {key}: the two-stage route launched "
                                 f"{ts_launches}")
        c["vs_two_stage_float16"] = float_code_diff(got, ts_out, 1023)
        c["two_stage_float16_digest"] = digest(ts_out)
        del got, ts_out
        cm = cmat_epilogue(np.concatenate(
            [np.asarray(p.cmat_m, np.float32),
             np.asarray(p.cmat_c, np.float32)[:, None]], 1))
        got = rk.mega3_tail(*two, *maps, cm, nrm)
        torch.cuda.synchronize()
        c["max_abs_err_cmat"] = (got - rk.mega3_tail_plain(
            *two, *maps, cm, nrm)).abs().max().item()
        c["cmat_digest"] = digest(got)
        if K4_ROUTES:
            c["cmat_route"] = rk.mega3_tail_route(b16[0].dtype, b16[1].dtype,
                                                  cm, long_window)
        del got
        worst = max(c["vs_plain"]["max_code_diff"],
                    c["vs_two_stage_float16"]["max_code_diff"])
        if worst > 1 or c["vs_plain"]["frac_differing"] >= 0.02 \
                or c["vs_two_stage_float16"]["frac_differing"] >= 0.02 \
                or c["max_abs_err_cmat"] > 1e-5 \
                or not c.get("long_window_bit_equal", True):
            raise AssertionError(f"K4 {key} disagrees: {c}")
        c["max_abs_err"] = max(worst / 1023.0, c["max_abs_err_cmat"])
        c["ms"] = k4_timed(lambda: rk.mega3_tail(*b16, *maps, epi, nrm))
        # the same call with the colour matrix alone: the input, W, H and
        # store without the tail's transfer functions and dither
        c["cmat_ms"] = k4_timed(lambda: rk.mega3_tail(*b16, *maps, cm, nrm))
        if K4_ROUTES and not long_window:
            c["long_window_ms"] = forced_long(
                rk, "K4_LONG_WINDOW",
                lambda: k4_timed(lambda: rk.mega3_tail(*b16, *maps, epi,
                                                       nrm)))
            c["tile_ms"], c["tiles_bit_equal"] = k4_tiles(
                lambda f: rk.mega3_tail(*(b16 if f is None else f), *maps,
                                        epi, nrm), two, (2, 2),
                (ky, kc, hy, hc))
            if not c["tiles_bit_equal"]:
                raise AssertionError(f"K4 {key}: tiles differ")
        del two
        c["plain_ms"] = cuda_ms(
            lambda: rk.mega3_tail_plain(*b16, *maps, epi, nrm), reps=1)
        mid16_fn = make_serving_fn(p)
        packed_fn = make_serving_fn(p, pack_surface=True)
        c["two_stage_ms"] = cuda_ms(lambda: mid16_fn(b16, rt))
        c["two_stage_packed_ms"] = cuda_ms(lambda: packed_fn(b16, rt))
        # the raw planes read once, float32 RGB written once; operations:
        # the W taps once per W output, the H taps once per output, the
        # colour matrix (the tail's transcendentals are not counted)
        hy_in, hc_in = b16[0].shape[-2], b16[1].shape[-2]
        c.update(bound(tbytes(*b16) + BATCH * 3 * oh * ow * 4
                       + mbytes(ky, kc, hy, hc),
                       map_flops(ky, BATCH * hy_in)
                       + 2 * map_flops(kc, BATCH * hc_in)
                       + map_flops(hy, BATCH * ow) + 2 * map_flops(hc, BATCH * ow)
                       + 18 * BATCH * oh * ow), library_ms=None)
        k4_cases[key] = c
        k4_runs.append((b16, maps, epi, nrm))
        del mid16_fn, packed_fn, f16
    k4_outs, k4_launches = count_launches(
        lambda: [rk.mega3_tail(*b, *m, e, n) for b, m, e, n in k4_runs])
    if k4_launches != only(mega3_tail=len(k4_runs)):
        raise AssertionError(f"K4 launches {k4_launches}")
    for o, (b, m, _, _) in zip(k4_outs, k4_runs):
        if o.shape != (BATCH, 3, m[4], b[0].shape[-1] if m[0] is None
                       else m[0].out_size) or not torch.isfinite(o).all():
            raise AssertionError(f"K4 output {tuple(o.shape)}")
    del k4_outs, k4_runs
    k4 = dict(k4_cases["headline"],
              max_abs_err=max(c["max_abs_err"] for c in k4_cases.values()))
    line("K4", frames=PLAIN_FRAMES, timed_batch=BATCH, launches=k4_launches,
         tolerance="dithered float <= 1 code on < 2% of channels vs plain and "
                   "vs the FLOAT16 two-stage route; matrix only f32 <= 1e-5; "
                   "the long-window route and every tile bit-equal",
         **k4_cases)
    torch.cuda.empty_cache()
    return k4, k4_launches


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs an NVIDIA card: CUDA is not "
                           "available")
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    line("device", name=name, nvidia_smi=smi(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    t = time.perf_counter()
    lib = build.build()
    build.load()
    line("build", seconds=round(time.perf_counter() - t, 3), library=str(lib))

    # 3. K1 at the headline shapes: luma (B,2160,3840) and chroma
    #    (B,1080,1920) uint16 -> 1920 columns
    src, dst = headline_args()
    y, u, v = p010_batch(BATCH, SEED, dev)
    plan = plan_pipeline(headline_settings(True), src, dst)
    wx = scale.upscale_matrix(Upscaling.LANCZOS3, W, OW)
    wy = scale.upscale_matrix(Upscaling.LANCZOS3, H, OH)
    ux, uy = chroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, ChromaScaling.BILINEAR, plan.src.chroma_location)
    norm = 1.0 / 65535.0
    kw_y = rk.BandedMatrix(wx, pre_scale=norm)
    kw_c = rk.BandedMatrix(ux @ wx, pre_scale=norm)
    k1 = {"max_code_diff": 0, "max_abs_err": 0.0}
    mids, f32_digest = [], hashlib.sha256()
    for plane, mat in ((y, kw_y), (u, kw_c), (v, kw_c)):
        for mid16 in (True, False):
            got = rk.banded_resize_last_axis(plane, mat, mid16=mid16)
            torch.cuda.synchronize()
            ref = rk.banded_resize_last_axis_plain(plane, mat, mid16=mid16)
            err = (got.float() - ref.float()).abs().max().item()
            if mid16:
                k1["max_code_diff"] = max(k1["max_code_diff"], int(err))
                mids.append(got)
            else:
                k1["max_abs_err"] = max(k1["max_abs_err"], err)
                f32_digest.update(digest(got).encode())
            del got, ref
    if k1["max_code_diff"] > 1 or k1["max_abs_err"] > 2e-5:
        raise AssertionError(f"K1 disagrees with its plain version: {k1}")

    def k1_all(f):
        return lambda: [f(p, m, True) for p, m in ((y, kw_y), (u, kw_c),
                                                   (v, kw_c))]
    k1_digest = {"mid16": digest(*mids), "float32": f32_digest.hexdigest()}
    k1["ms"] = cuda_ms(k1_all(rk.banded_resize_last_axis))
    k1["plain_ms"] = cuda_ms(k1_all(rk.banded_resize_last_axis_plain))
    k1.update(bound(tbytes(y, u, v, *mids) + mbytes(kw_y, kw_c),
                    map_flops(kw_y, y.numel() // W)
                    + 2 * map_flops(kw_c, u.numel() // (W // 2))))
    # the library call: one float32 product per plane, TF32 off
    xf = [(p.float(), m.dense_on(dev)) for p, m in ((y, kw_y), (u, kw_c),
                                                    (v, kw_c))]
    k1["library_ms"] = cuda_ms(lambda: [torch.matmul(a, d) for a, d in xf])
    del xf
    line("K1", batch=BATCH, tolerance="mid16 <= 1 code, f32 <= 2e-5",
         k1_digest=k1_digest, **k1)

    # 4. K2 at the headline shapes on the K1 mid16 planes, headline epilogue
    unscale = 1.0 / rk.MID16_SCALE
    kh_y = rk.BandedMatrix(wy, pre_scale=unscale)
    kh_c = rk.BandedMatrix(uy @ wy, pre_scale=unscale)
    epi = _make_tail_epilogue(plan)
    args = (*mids, kh_y, kh_c, OH, epi)
    got = rk.rows3_tail(*args, pack_format="rgb10a2")
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*args, pack_format="rgb10a2")
    d = (codes(got, 10) - codes(ref, 10)).abs()
    k2 = {"max_code_diff": int(d.max().item()),
          "frac_differing": float((d > 0).double().mean().item()),
          "alpha_ok": bool(torch.equal(got >> 30, ref >> 30))}
    k2_digest = digest(got)
    del got, ref, d
    if k2["max_code_diff"] > 1 or k2["frac_differing"] >= 0.02 \
            or not k2["alpha_ok"]:
        raise AssertionError(f"K2 disagrees with its plain version: {k2}")
    k2["max_abs_err"] = k2["max_code_diff"] / 1023.0
    k2["ms"] = cuda_ms(lambda: rk.rows3_tail(*args, pack_format="rgb10a2"))
    k2["plain_ms"] = cuda_ms(
        lambda: rk.rows3_tail_plain(*args, pack_format="rgb10a2"))
    # operations: the tap FMAs and the colour matrix (the tail's
    # transcendentals are not counted)
    k2.update(bound(tbytes(*mids) + BATCH * OH * OW * 4 + mbytes(kh_y, kh_c),
                    map_flops(kh_y, BATCH * OW) + 2 * map_flops(kh_c, BATCH * OW)
                    + 18 * BATCH * OH * OW), library_ms=None)
    line("K2", batch=BATCH, tolerance="<= 1 code on < 2% of channels",
         k2_digest=k2_digest, **k2)
    del mids, args, y, u, v
    torch.cuda.empty_cache()

    # 5. the slice through VideoProcessor
    batches = [p010_batch(BATCH, SEED + 1 + i, dev) for i in range(3)]
    single = p010_batch(1, SEED + 4, dev)
    vp = VideoProcessor(headline_settings(True), src, dst, device=dev,
                        pack_surface=True)
    vp.process(batches[0])                      # warm-up, before the count
    torch.cuda.synchronize()
    rk.reset_launches()
    outs, times = [], []
    for b in batches + [single]:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = vp.process(b)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        outs.append(out)
    launches = dict(rk.launches)
    calls = len(batches) + 1
    if launches != only(banded_resize_last_axis=3 * calls, rows3_tail=calls):
        raise AssertionError(f"main path launches {launches} for {calls} calls")
    for o, b in zip(outs, batches + [single]):
        if o.shape != (b[0].shape[0], OH, OW) or o.dtype != torch.int32:
            raise AssertionError(f"output {tuple(o.shape)} {o.dtype}")
    ref0 = oracle(batches[0][0][0], batches[0][1][0], batches[0][2][0], OW, OH)
    db = psnr(codes(outs[0][0], 10).double() / 1023.0, ref0)
    db_single = psnr(codes(outs[3][0], 10).double() / 1023.0,
                     oracle(single[0][0], single[1][0], single[2][0], OW, OH))
    del outs
    plain_vp = VideoProcessor(headline_settings(False), src, dst, device=dev,
                              pack_surface=True)
    plain_out = plain_vp.process(batches[0])
    db_plain = psnr(codes(plain_out[0], 10).double() / 1023.0, ref0)
    del plain_out
    ms_kernel = sum(times[:3]) / (3 * BATCH)
    ms_plain = cuda_ms(lambda: [plain_vp.process(b) for b in batches],
                       reps=1, warmup=0) / (3 * BATCH)
    if min(db, db_single, db_plain) < 55.0:
        raise AssertionError(f"PSNR below 55 dB: {db}, {db_single}, {db_plain}")
    line("slice", batch=BATCH, calls=calls, launches=launches,
         psnr_db=db, psnr_db_batch1=db_single, psnr_db_plain=db_plain,
         ms_per_frame=ms_kernel, plain_ms_per_frame=ms_plain,
         ms_batch1=times[3])
    del batches, single, plain_vp, vp
    torch.cuda.empty_cache()

    # 6. c1: 1080p NV12 -> RGBA8 1:1, dithered, packed
    rng = np.random.default_rng(SEED + 5)
    n12 = tuple(torch.from_numpy(p).to(dev) for p in (
        rng.integers(16, 236, (BATCH, C1_H, C1_W), dtype=np.uint8),
        rng.integers(16, 241, (BATCH, C1_H // 2, C1_W // 2), dtype=np.uint8),
        rng.integers(16, 241, (BATCH, C1_H // 2, C1_W // 2), dtype=np.uint8)))
    c1 = VideoProcessor(
        Settings(chroma_scaling=ChromaScaling.BILINEAR),
        SourceDescriptor(format=ColorFormat.NV12, width=C1_W, height=C1_H,
                         matrix=CSP.BT_709, levels=Levels.TV),
        OutputDescriptor(width=C1_W, height=C1_H, bits=8), device=dev,
        pack_surface=True)
    rk.reset_launches()
    out = c1.process(n12)
    torch.cuda.synchronize()
    c1_launches = dict(rk.launches)
    if c1_launches != only(banded_resize_last_axis=2, rows3_tail=1):
        raise AssertionError(f"c1 launches {c1_launches}")
    want = oracle(n12[0][0], n12[1][0], n12[2][0], C1_W, C1_H, bits_in=8,
                  matrix=CSP.BT_709, pq_to_sdr=False, dither_bits=8)
    db_c1 = psnr(codes(out[0], 8).double() / 255.0, want)
    if db_c1 < 55.0:
        raise AssertionError(f"c1 PSNR {db_c1} below 55 dB")
    c1_ms = cuda_ms(lambda: c1.process(n12)) / BATCH
    line("c1", batch=BATCH, psnr_db=db_c1, launches=c1_launches,
         ms_per_frame=c1_ms, k2_digest=digest(out))

    del n12, c1, out
    torch.cuda.empty_cache()

    # 7. K6 at the c3 shapes, kernel against plain on PLAIN_FRAMES frames
    plan3 = plan_pipeline(*c3_args())
    ux3, uy3 = chroma.chroma_upsample_matrices(
        C1_W // 2, C1_H // 2, 420, ChromaScaling.BILINEAR,
        plan3.src.chroma_location)
    cmat3 = np.concatenate([np.asarray(plan3.cmat_m, np.float32),
                            np.asarray(plan3.cmat_c, np.float32)[:, None]], 1)
    j2_epi = jk.dither_epilogue(8)
    small = nv12_batch(PLAIN_FRAMES, SEED + 6, dev)
    # as the staged path calls it: the chroma normalisation in the W taps
    k6_args = (*small, rk.BandedMatrix(uy3),
               rk.BandedMatrix(ux3, pre_scale=1 / 255.0), cmat3, C3_OH, C3_OW,
               1 / 255.0, 1.0)
    # c3rot's call: the 2160-wide x 3840-high plan (9/8 across, 32/9 down),
    # stored transposed
    k6_rot_args = (*k6_args[:6], C3_OW, C3_OH, *k6_args[8:])
    k6 = {"max_code_diff": 0, "frac_differing": 0.0}
    k6_digests = []
    for a, transpose in ((k6_args, False), (k6_args, True),
                         (k6_rot_args, True)):
        kw = dict(epilogue=j2_epi, pack_format="rgba8", out_transpose=transpose)
        got = jk.jinc2_convert_fused(*a, **kw)
        torch.cuda.synchronize()
        ref = jk.jinc2_convert_fused_plain(*a, **kw)
        dd = code_diff(got, ref, 8)
        k6 = {k: max(k6[k], dd[k]) for k in k6}
        k6_digests.append(digest(got))
        del got, ref
    if k6["max_code_diff"] > 1 or k6["frac_differing"] >= 0.01:
        raise AssertionError(f"K6 disagrees with its plain version: {k6}")
    k6["max_abs_err"] = k6["max_code_diff"] / 255.0
    kw = dict(epilogue=j2_epi, pack_format="rgba8")
    # the per-output route on c3's call: the table's weights are the ones
    # K6 computes for each output, so the bits are the table route's
    with per_output_weights():
        got = jk.jinc2_convert_fused(*k6_args, **kw)
        torch.cuda.synchronize()
        k6["per_output_digest"] = digest(got)
        del got
        k6["per_output_ms"] = cuda_ms(
            lambda: jk.jinc2_convert_fused(*k6_args, **kw))
    k6["per_output_bit_equal"] = k6["per_output_digest"] == k6_digests[0]
    if not k6["per_output_bit_equal"]:
        raise AssertionError("K6's per-output route differs from its table "
                             "route")
    k6["ms"] = cuda_ms(lambda: jk.jinc2_convert_fused(*k6_args, **kw))
    k6["plain_ms"] = cuda_ms(
        lambda: jk.jinc2_convert_fused_plain(*k6_args, **kw), reps=2)
    # operations: the 16 Jinc2 taps of three channels per output (the
    # weights' transcendentals and the convert are not counted)
    k6.update(bound(tbytes(*small) + PLAIN_FRAMES * C3_OH * C3_OW * 4
                    + mbytes(k6_args[3], k6_args[4]),
                    PLAIN_FRAMES * C3_OH * C3_OW * 3 * 16 * 2),
              library_ms=None)
    line("K6", frames=PLAIN_FRAMES, cases="c3, c3 transposed, c3rot",
         tolerance="<= 1 code on < 1% of channels", digests=k6_digests, **k6)
    del small, k6_args, k6_rot_args

    # 8. K5 at (6, 1080, 1920) -> (2160, 3840) float32: float, dithered and
    #    rounded against the plain version; the dithered call on the
    #    per-output route too (the table cap at 0), bit-equal to the table
    #    route, and both timed; then K5 timed at c3r270's 48 planes
    rng = np.random.default_rng(SEED + 7)
    x5 = torch.from_numpy(rng.random((3 * PLAIN_FRAMES, C1_H, C1_W),
                                     dtype=np.float32)).to(dev)
    k5_geom = (C1_H, C1_W, C3_OH, C3_OW)
    got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW)
    torch.cuda.synchronize()
    k5 = {"route": k5_route(*k5_geom),
          "max_abs_err": (got - jk.jinc2_resize_fused_plain(
              x5, C3_OH, C3_OW)).abs().max().item()}
    k5_float = digest(got)
    got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi)
    torch.cuda.synchronize()
    ref = jk.jinc2_resize_fused_plain(x5, C3_OH, C3_OW, j2_epi)
    k5_digests = [k5_float, digest(got)]
    d = ((got - ref) * 255.0).abs().round()
    k5["max_code_diff"] = int(d.max().item())
    k5["frac_differing"] = float((d > 0).double().mean().item())
    del got, ref, d
    j2_round = jk.dither_epilogue(-8)
    got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_round)
    torch.cuda.synchronize()
    ref = jk.jinc2_resize_fused_plain(x5, C3_OH, C3_OW, j2_round)
    k5["rounded_digest"] = digest(got)
    d = ((got - ref) * 255.0).abs().round()
    k5["rounded_max_code_diff"] = int(d.max().item())
    k5["rounded_frac_differing"] = float((d > 0).double().mean().item())
    del got, ref, d
    if k5["max_abs_err"] > 1e-5 or max(k5["max_code_diff"],
                                       k5["rounded_max_code_diff"]) > 1 \
            or max(k5["frac_differing"], k5["rounded_frac_differing"]) >= 0.01:
        raise AssertionError(f"K5 disagrees with its plain version: {k5}")
    with per_output_weights():
        k5["per_output_route"] = k5_route(*k5_geom)
        got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi)
        torch.cuda.synchronize()
        k5["per_output_digest"] = digest(got)
        del got
        k5["per_output_ms"] = cuda_ms(
            lambda: jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi))
    k5["per_output_bit_equal"] = k5["per_output_digest"] == k5_digests[1]
    if not k5["per_output_bit_equal"]:
        raise AssertionError("K5's per-output route differs from its table "
                             "route")
    k5["ms"] = cuda_ms(lambda: jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi))
    k5["plain_ms"] = cuda_ms(
        lambda: jk.jinc2_resize_fused_plain(x5, C3_OH, C3_OW, j2_epi), reps=2)
    k5.update(bound(tbytes(x5) + x5.shape[0] * C3_OH * C3_OW * 4,
                    x5.shape[0] * C3_OH * C3_OW * 16 * 2), library_ms=None)
    del x5
    torch.cuda.empty_cache()
    # at c3r270's batch: 16 frames' R, G and B planes
    x48 = torch.from_numpy(rng.random((C3R270_PLANES, C1_H, C1_W),
                                      dtype=np.float32)).to(dev)
    k5["ms_c3r270_planes"] = cuda_ms(
        lambda: jk.jinc2_resize_fused(x48, C3_OH, C3_OW, j2_epi), reps=3)
    k5["bound_ms_c3r270_planes"] = bound(
        tbytes(x48) + C3R270_PLANES * C3_OH * C3_OW * 4,
        C3R270_PLANES * C3_OH * C3_OW * 16 * 2)["bound_ms"]
    del x48
    line("K5", planes=3 * PLAIN_FRAMES,
         tolerance="float <= 1e-5; dithered, rounded <= 1 code on < 1%",
         digests=k5_digests, **k5)
    torch.cuda.empty_cache()

    # 9. c3 through VideoProcessor: two distinct batches of 16
    c3_batches = [nv12_batch(BATCH, SEED + 8 + i, dev) for i in range(2)]
    c3 = VideoProcessor(*c3_args(), device=dev, pack_surface=True)
    # the path's first call (the warm-up, before the count) builds its
    # geometry's weight table; its K6 call is kept for K6's time at batch 16
    fresh_tables()
    with recording(jk, "jinc2_convert_fused") as calls:
        _, c3_first = count_launches(lambda: c3.process(c3_batches[0]))
    if c3_first != only(jinc2_convert_fused=1, jinc2_weight_table=1):
        raise AssertionError(f"c3's first call launched {c3_first}")
    (a6, kw6, _), = calls["jinc2_convert_fused"]
    del calls
    c3_times = []

    def c3_run():
        outs = []
        for b in c3_batches:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(c3.process(b))
            t1.record()
            torch.cuda.synchronize()
            c3_times.append(t0.elapsed_time(t1))
        return outs

    c3_outs, c3_launches = count_launches(c3_run)
    if c3_launches != only(jinc2_convert_fused=len(c3_batches)):
        raise AssertionError(f"c3 launches {c3_launches}")
    for o in c3_outs:
        if o.shape != (BATCH, C3_OH, C3_OW) or o.dtype != torch.int32:
            raise AssertionError(f"c3 output {tuple(o.shape)} {o.dtype}")
    b0 = c3_batches[0]
    db_c3 = psnr(codes(c3_outs[0][0], 8).double() / 255.0,
                 oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OW, C3_OH))
    if db_c3 < 55.0:
        raise AssertionError(f"c3 PSNR {db_c3} below 55 dB")
    c3_ms = sum(c3_times) / (len(c3_times) * BATCH)
    k6["ms_batch16"] = cuda_ms(lambda: jk.jinc2_convert_fused(*a6, **kw6))
    k6["bound_ms_batch16"] = bound(
        tbytes(*a6[:3]) + BATCH * C3_OH * C3_OW * 4 + mbytes(a6[3], a6[4]),
        BATCH * C3_OH * C3_OW * 3 * 16 * 2)["bound_ms"]
    del a6, kw6
    line("c3", batch=BATCH, calls=len(c3_batches), launches=c3_launches,
         first_call_launches={k: v for k, v in c3_first.items() if v},
         psnr_db=db_c3, ms_per_frame=c3_ms,
         ms_per_frame_back_to_back=cuda_ms(
             lambda: [c3.process(b) for b in c3_batches], reps=1,
             warmup=0) / (len(c3_batches) * BATCH),
         k6_ms=k6["ms_batch16"], k6_bound_ms=k6["bound_ms_batch16"])
    del c3_outs

    # 10. c3rot: the 2160 x 3840 plan, rotation 90 + flip (a pure transpose)
    plan_rot = plan_pipeline(*c3_args(rotated=True))
    rot_fn = make_frame_fn(plan_rot, pack_surface=True, rotation=90, flip=True)
    fresh_tables()
    # the warm-up, before the count: the path's first call builds its table
    _, rot_first = count_launches(lambda: rot_fn(b0))
    if rot_first != only(jinc2_convert_fused=1, jinc2_weight_table=1):
        raise AssertionError(f"c3rot's first call launched {rot_first}")
    rot_out, rot_launches = count_launches(lambda: rot_fn(b0))
    if rot_launches != only(jinc2_convert_fused=1):
        raise AssertionError(f"c3rot launches {rot_launches}")
    if rot_out.shape != (BATCH, C3_OH, C3_OW):
        raise AssertionError(f"c3rot output {tuple(rot_out.shape)}")
    flat = make_frame_fn(plan_rot, pack_surface=True)(b0)
    rot_bit_equal = bool(torch.equal(rot_out, flat.transpose(-2, -1)))
    del flat
    if not rot_bit_equal:
        raise AssertionError("c3rot is not the transposed unrotated surface")
    db_rot = psnr(codes(rot_out[0], 8).double() / 255.0,
                  oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OH, C3_OW,
                               rotation=90, flip=True))
    if db_rot < 55.0:
        raise AssertionError(f"c3rot PSNR {db_rot} below 55 dB")
    rot_ms = cuda_ms(lambda: rot_fn(b0), reps=3) / BATCH
    line("c3rot", batch=BATCH, launches=rot_launches,
         first_call_launches={k: v for k, v in rot_first.items() if v},
         psnr_db=db_rot, bit_equal_to_transpose=rot_bit_equal,
         ms_per_frame=rot_ms)
    del rot_out
    # K6's weight table kernel at c3rot's 32 x 9 classes, against its plain
    # version (torch's sin beside the kernel's sinf: float32 rounding)
    k6t = None
    if TABLES:
        dyc = torch.tensor(jk.axis_classes(C1_H, C3_OW)[1], device=dev)
        dxc = torch.tensor(jk.axis_classes(C1_W, C3_OH)[1], device=dev)
        got = jk.jinc2_weight_table(dyc, dxc)
        torch.cuda.synchronize()
        ref = jk.jinc2_weight_table_plain(dyc, dxc)
        k6t = {"max_abs_err": (got - ref).abs().max().item(),
               "digest": digest(got)}
        if k6t["max_abs_err"] > 1e-6 * ref.abs().max().item():
            raise AssertionError(f"K6's table disagrees with its plain "
                                 f"version: {k6t}")
        k6t["ms"] = cuda_ms(lambda: jk.jinc2_weight_table(dyc, dxc))
        k6t["plain_ms"] = cuda_ms(
            lambda: jk.jinc2_weight_table_plain(dyc, dxc))
        # operations: per weight the sum of the two d2, the two sin
        # arguments, their product and the division (the sqrt and sin not
        # counted), and the 15 sums
        k6t.update(bound(tbytes(dyc, dxc, got), got.shape[0] * got.shape[1]
                         * (16 * 5 + 15)), library_ms=None)
        line("K6_table", geometry="c3rot", entries=got.shape[0] * got.shape[1],
             tolerance="f32 <= 1e-6 of the largest weight", **k6t)
        del got, ref, dyc, dxc

    # 11. c3 with rotation 270: the staged route K1 x2, K2, K5, then rotate.
    #     First its convert against the plain versions on PLAIN_FRAMES
    #     frames: K1 on the uint8 chroma (float out, the normalisation in
    #     the taps), then K2 reading the uint8 luma with the colour matrix
    #     only, float out (K5 at these shapes is phase 8)
    yc, uc, vc = (p[:PLAIN_FRAMES] for p in b0)
    kw_c3 = rk.BandedMatrix(ux3, pre_scale=1 / 255.0)
    conv, conv_k1 = {"k1_max_abs_err": 0.0}, []
    for plane in (uc, vc):
        got = rk.banded_resize_last_axis(plane, kw_c3)
        torch.cuda.synchronize()
        ref = rk.banded_resize_last_axis_plain(plane, kw_c3)
        conv["k1_max_abs_err"] = max(conv["k1_max_abs_err"],
                                     (got - ref).abs().max().item())
        conv_k1.append(digest(got))
        del got, ref
    uw = rk.banded_resize_last_axis_plain(uc, kw_c3)
    vw = rk.banded_resize_last_axis_plain(vc, kw_c3)
    k2_args = (yc, uw, vw, None, rk.BandedMatrix(uy3), C1_H,
               cmat_epilogue(cmat3))
    got = rk.rows3_tail(*k2_args, y_scale=1 / 255.0)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*k2_args, y_scale=1 / 255.0)
    conv["k2_max_abs_err"] = (got - ref).abs().max().item()
    conv["k1_digest"], conv["k2_digest"] = conv_k1, digest(got)
    del got, ref, uw, vw, k2_args, yc, uc, vc
    if conv["k1_max_abs_err"] > 2e-5 or conv["k2_max_abs_err"] > 1e-5:
        raise AssertionError(
            f"the rotation-270 convert disagrees with its plain version: {conv}")
    line("c3r270_convert", frames=PLAIN_FRAMES,
         tolerance="K1 f32 <= 2e-5, K2 f32 <= 1e-5", **conv)

    r270_fn = make_frame_fn(plan3, pack_surface=True, rotation=270)
    path = only(banded_resize_last_axis=2, rows3_tail=1, jinc2_resize_fused=1)
    # K5 and K6 share c3's weight table: whichever path calls first builds
    # it, and the other builds none (K5's table route only)
    shared = K5_ROUTES and k5_route(C1_H, C1_W, C3_OH, C3_OW).startswith(
        "table")
    table_first = {"jinc2_weight_table": int(shared)}
    fresh_tables()
    _, r270_first = count_launches(lambda: r270_fn(b0))   # the warm-up
    _, c3_after = count_launches(lambda: c3.process(b0))
    fresh_tables()
    _, c3_before = count_launches(lambda: c3.process(b0))
    _, r270_after = count_launches(lambda: r270_fn(b0))
    if (r270_first, c3_after, c3_before, r270_after) != (
            {**path, **table_first},
            only(jinc2_convert_fused=1,
                 jinc2_weight_table=int(TABLES and not shared)),
            only(jinc2_convert_fused=1, jinc2_weight_table=int(TABLES)),
            path):
        raise AssertionError(
            f"c3 rotation 270 and c3 share no table: first calls "
            f"{r270_first}, {c3_after}; {c3_before}, {r270_after}")
    r270_out, r270_launches = count_launches(lambda: r270_fn(b0))
    if r270_launches != path:
        raise AssertionError(f"c3 rotation 270 launches {r270_launches}")
    db_270 = psnr(codes(r270_out[0], 8).double() / 255.0,
                  oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OW, C3_OH,
                               rotation=270))
    if db_270 < 55.0:
        raise AssertionError(f"c3 rotation 270 PSNR {db_270} below 55 dB")
    r270_ms = cuda_ms(lambda: r270_fn(b0), reps=3) / BATCH
    line("c3r270", batch=BATCH, launches=r270_launches, psnr_db=db_270,
         first_call_launches={k: v for k, v in r270_first.items() if v},
         k5_route=k5_route(C1_H, C1_W, C3_OH, C3_OW),
         ms_per_frame=r270_ms, surface_digest=digest(r270_out))
    del r270_out, c3_batches, b0
    torch.cuda.empty_cache()

    # 12. K7 at c5's shapes: 2 frames against the plain version, both field
    #     orders, next equal to prev on the left half (weave, ramp and bob
    #     all occur); then timed on the 16-frame window of a c5 step
    plan5 = plan_pipeline(*c5_args())
    c5_batches = [p010_batch(BATCH, SEED + 9 + i, dev) for i in range(2)]
    b0 = c5_batches[0]

    def left_half_of(a, b):
        return torch.cat([a[..., :a.shape[-1] // 2],
                          b[..., a.shape[-1] // 2:]], dim=-1)

    n = PLAIN_FRAMES
    prev2 = tuple(p[0:n] for p in b0)
    win2 = (prev2, tuple(p[1:1 + n] for p in b0),
            tuple(left_half_of(a, p[2:2 + n]) for a, p in zip(prev2, b0)))
    wx5 = scale.upscale_matrix(Upscaling.LANCZOS3, W, OW)
    wy5 = scale.upscale_matrix(Upscaling.LANCZOS3, H, OH)
    ux5, uy5 = chroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, ChromaScaling.BILINEAR, plan5.src.chroma_location)
    my_y = rk.BandedMatrix(wy5, pre_scale=norm)
    my_c = rk.BandedMatrix(uy5 @ wy5, pre_scale=norm)
    thr = 8.0 / 255.0 * 65535.0
    k7, k7_digests = {"max_abs_err": 0.0}, []
    for tff in (True, False):
        args = (*win2, my_y, my_c, OH, thr, tff)
        got = dk.deint3_rows_dual(*args)
        torch.cuda.synchronize()
        ref = dk.deint3_rows_dual_plain(*args)
        k7["max_abs_err"] = max(k7["max_abs_err"], *(
            (g - r).abs().max().item() for g, r in zip(got, ref)))
        k7_digests.append(digest(*got))
        if tff:
            k7_fields = got
        del got, ref
    if k7["max_abs_err"] > 2e-5:
        raise AssertionError(f"K7 disagrees with its plain version: {k7}")
    # a c5 step's window: the stream's first frame clamped, then 16 + 1
    arr = tuple(torch.cat([p[:1], p, q[:1]])
                for p, q in zip(b0, c5_batches[1]))
    win16 = [tuple(p[i:i + BATCH] for p in arr) for i in range(3)]
    k7_16 = (*win16, my_y, my_c, OH, thr, True)
    k7["ms"] = cuda_ms(lambda: dk.deint3_rows_dual(*k7_16))
    k7["plain_ms"] = cuda_ms(
        lambda: dk.deint3_rows_dual_plain(*k7_16), reps=2)
    # the three windows are overlapping slices of one buffer: its BATCH + 2
    # frames are read once; both fields of three planes out; operations:
    # the H taps of both fields
    k7.update(bound(tbytes(*arr)
                    + 2 * BATCH * OH * (W + W) * 4 + mbytes(my_y, my_c),
                    2 * (map_flops(my_y, BATCH * W)
                         + 2 * map_flops(my_c, BATCH * W // 2))),
              library_ms=None)
    line("K7", frames=n, field_orders=["top first", "bottom first"],
         timed_frames=BATCH, tolerance="f32 <= 2e-5", digests=k7_digests,
         **k7)

    # 13. K9 at c5's shapes: K7's 2-frame output read as 4 fields, c5's
    #     epilogue, RGBA8; then timed on the 32 fields of a c5 step
    epi5 = _make_tail_epilogue(plan5)
    mx_y, mx_c = rk.BandedMatrix(wx5), rk.BandedMatrix(ux5 @ wx5)

    def as_fields(stacked):
        return tuple(o.reshape((-1,) + o.shape[-2:]) for o in stacked)

    k9_args = (*as_fields(k7_fields), mx_y, mx_c, OW, epi5)
    got = dk.cols3_tail(*k9_args, pack_format="rgba8")
    torch.cuda.synchronize()
    ref = dk.cols3_tail_plain(*k9_args, pack_format="rgba8")
    k9 = code_diff(got, ref, 8)
    k9["alpha_ok"] = bool(torch.equal(got >> 24, ref >> 24))
    k9_digest = digest(got)
    del got, ref, k7_fields, k9_args
    if k9["max_code_diff"] > 1 or k9["frac_differing"] >= 0.02 \
            or not k9["alpha_ok"]:
        raise AssertionError(f"K9 disagrees with its plain version: {k9}")
    k9["max_abs_err"] = k9["max_code_diff"] / 255.0
    k9_32 = (*as_fields(dk.deint3_rows_dual(*k7_16)), mx_y,
             mx_c, OW, epi5)
    k9["ms"] = cuda_ms(lambda: dk.cols3_tail(*k9_32, pack_format="rgba8"))
    k9["plain_ms"] = cuda_ms(
        lambda: dk.cols3_tail_plain(*k9_32, pack_format="rgba8"), reps=2)
    rows9 = k9_32[0].numel() // W
    k9.update(bound(tbytes(*k9_32[:3]) + rows9 * OW * 4 + mbytes(mx_y, mx_c),
                    map_flops(mx_y, rows9) + 2 * map_flops(mx_c, rows9)
                    + 18 * rows9 * OW), library_ms=None)
    # the tail and the store alone: the same epilogue on OW-wide planes read
    # directly (the luma's first OW columns), no W map
    direct9 = (k9_32[0][..., :OW].contiguous(), k9_32[1], k9_32[2], None,
               None, OW, epi5)
    k9["tail_ms"] = cuda_ms(lambda: dk.cols3_tail(
        *direct9, y_scale=1.0, c_scale=1.0, pack_format="rgba8"))
    del direct9
    line("K9", fields=2 * n, timed_fields=2 * BATCH,
         tolerance="<= 1 code on < 2% of channels", digest=k9_digest, **k9)
    del k9_32, k7_16, win16, arr, win2, prev2
    torch.cuda.empty_cache()

    # 14. c5: the double-rate session, two distinct batches of 16 and the
    #     flush; every step K7 x1 + K9 x1
    sess = DeinterlaceSession(plan5, double_rate=True, pack_surface=True,
                              device=dev)

    def c5_run():
        outs = []
        for b in c5_batches:
            outs += sess.push_batch(b)
        return outs + sess.flush_batch()

    c5_outs, c5_launches = count_launches(c5_run)
    c5_digest = digest(*c5_outs)
    steps = len(c5_batches) + 1
    if c5_launches != only(deint3_rows_dual=steps, cols3_tail=steps):
        raise AssertionError(f"c5 launches {c5_launches}")
    want = [BATCH - 1] * 2 + [BATCH] * 2 + [1] * 2
    for o, nf in zip(c5_outs, want):
        if o.shape != (nf, OH, OW) or o.dtype != torch.int32:
            raise AssertionError(f"c5 output {tuple(o.shape)} {o.dtype}")
    if len(c5_outs) != len(want):
        raise AssertionError(f"c5 gave {len(c5_outs)} outputs")
    f0 = tuple(p[0] for p in b0)
    f1 = tuple(p[1] for p in b0)
    db5 = [psnr(codes(c5_outs[f][0], 8).double() / 255.0,
                oracle_deint(f0, f0, f1, OW, OH, field=f)) for f in (0, 1)]
    del c5_outs
    if min(db5) < 55.0:
        raise AssertionError(f"c5 PSNR below 55 dB: {db5}")
    # back to back: a running stream, each push 16 frames = 32 fields
    sess_b2b = DeinterlaceSession(plan5, pack_surface=True, device=dev)
    sess_b2b.push_batch(b0)
    ms_field = cuda_ms(lambda: sess_b2b.push_batch(c5_batches[1]),
                       reps=4) / (2 * BATCH)
    # batch 1: one frame a push, synced (host clock)
    sess_1 = DeinterlaceSession(plan5, pack_surface=True, device=dev)
    sess_1.push_batch(tuple(p[0:1] for p in b0))
    t1 = []
    for i in range(1, BATCH):
        t0 = time.perf_counter()
        sess_1.push_batch(tuple(p[i:i + 1] for p in b0))
        torch.cuda.synchronize()
        t1.append((time.perf_counter() - t0) * 1e3)
    # the plain path (use_accel_backend=False): deinterlace in torch, then
    # the plain fused pipeline per field
    plan5p = plan_pipeline(*c5_args(accel=False))
    sess_p = DeinterlaceSession(plan5p, pack_surface=True, device=dev)
    plain_out = sess_p.push_batch(b0)
    db5_plain = psnr(codes(plain_out[0][0], 8).double() / 255.0,
                     oracle_deint(f0, f0, f1, OW, OH, field=0))
    del plain_out
    plain_ms_field = cuda_ms(lambda: sess_p.push_batch(c5_batches[1]),
                             reps=1) / (2 * BATCH)
    # single rate at batch 16: the deinterlace in torch, K1 x3 + K2 x1
    fn1 = make_deint_frame_fn(plan5, field=0, pack_surface=True)
    prev1 = tuple(torch.cat([p[:1], p[:-1]]) for p in b0)
    next1 = tuple(torch.cat([p[1:], p[-1:]]) for p in b0)
    sr_out, sr_launches = count_launches(lambda: fn1(prev1, b0, next1))
    if sr_launches != only(banded_resize_last_axis=3, rows3_tail=1):
        raise AssertionError(f"c5 single-rate launches {sr_launches}")
    if sr_out.shape != (BATCH, OH, OW):
        raise AssertionError(f"c5 single-rate output {tuple(sr_out.shape)}")
    sr_digest = digest(sr_out)
    db_sr = psnr(codes(sr_out[0], 8).double() / 255.0,
                 oracle_deint(f0, f0, f1, OW, OH, field=0))
    del sr_out
    if db_sr < 55.0 or db5_plain < 55.0:
        raise AssertionError(f"c5 PSNR below 55 dB: single rate {db_sr}, "
                             f"plain {db5_plain}")
    sr_ms = cuda_ms(lambda: fn1(prev1, b0, next1), reps=3) / BATCH
    # single rate's kernels at the shapes, dtypes and epilogue the path
    # gives them, on PLAIN_FRAMES frames: every K1 call (float32
    # deinterlaced planes in raw code units, the path's own W maps and
    # mid16 choice) and the K2 call (c5's HLG -> SDR tail, RGBA8), each
    # against its plain version on the same inputs
    with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
        fn1(*(tuple(p[:n] for p in f) for f in (prev1, b0, next1)))
    torch.cuda.synchronize()
    k1_calls, k2_calls = calls["banded_resize_last_axis"], calls["rows3_tail"]
    if len(k1_calls) != 3 or len(k2_calls) != 1:
        raise AssertionError("c5 single rate recorded "
                             f"{len(k1_calls)} K1 and {len(k2_calls)} K2 calls")
    sr_k = {"k1_inputs": sorted({str(a[0].dtype) for a, _, _ in k1_calls}),
            "k1_outputs": sorted({str(o.dtype) for _, _, o in k1_calls}),
            "k1_max_code_diff": 0, "k1_max_abs_err": 0.0,
            "k1_digest": digest(*(o for _, _, o in k1_calls)),
            "k2_digest": digest(k2_calls[0][2])}
    if sr_k["k1_inputs"] != ["torch.float32"]:
        raise AssertionError(f"c5 single rate fed K1 {sr_k['k1_inputs']}")
    for a, kw, got in k1_calls:
        ref = rk.banded_resize_last_axis_plain(*a, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        if got.dtype == torch.int16:     # mid16 codes
            sr_k["k1_max_code_diff"] = max(sr_k["k1_max_code_diff"], int(err))
        else:
            sr_k["k1_max_abs_err"] = max(sr_k["k1_max_abs_err"], err)
        del ref
    (a, kw, got), = k2_calls
    if a[6].correction != rk.CORR_HLG_TO_SDR or kw.get("pack_format") != "rgba8":
        raise AssertionError("c5 single rate: K2 epilogue "
                             f"{a[6].correction}, pack {kw.get('pack_format')}")
    ref = rk.rows3_tail_plain(*a, **kw)
    sr_k.update({"k2_" + k: x for k, x in code_diff(got, ref, 8).items()})
    sr_k["k2_alpha_ok"] = bool(torch.equal(got >> 24, ref >> 24))
    del calls, k1_calls, k2_calls, a, kw, got, ref
    if sr_k["k1_max_code_diff"] > 1 or sr_k["k1_max_abs_err"] > 2e-5 \
            or sr_k["k2_max_code_diff"] > 1 \
            or sr_k["k2_frac_differing"] >= 0.02 or not sr_k["k2_alpha_ok"]:
        raise AssertionError(
            f"c5 single rate's K1 or K2 disagrees with its plain version: {sr_k}")
    sr_k["k2_max_abs_err"] = sr_k["k2_max_code_diff"] / 255.0
    line("c5", batch=BATCH, steps=steps, launches=c5_launches,
         psnr_db_field0=db5[0], psnr_db_field1=db5[1],
         psnr_db_plain=db5_plain, ms_per_field=ms_field, digest=c5_digest,
         plain_ms_per_field=plain_ms_field,
         ms_per_frame_batch1_median=float(np.median(t1)),
         ms_per_frame_batch1_p90=float(np.percentile(t1, 90)),
         single_rate={"launches": sr_launches, "psnr_db": db_sr,
                      "output_digest": sr_digest,
                      "ms_per_frame": sr_ms, "kernels_frames": n,
                      "tolerance": "K1 mid16 <= 1 code, f32 <= 2e-5; K2 <= 1 "
                                   "code on < 2% of channels", **sr_k})
    del c5_batches, b0, prev1, next1, sess, sess_b2b, sess_1, sess_p
    torch.cuda.empty_cache()

    # 15. K8 at c8's shapes on PLAIN_FRAMES frames, through the runtime-
    #     scalar route: each K8 (and K9) call of the serving function on a
    #     scene's curves, held against its plain version on the same inputs;
    #     c8's metadata and the variant where nothing folds
    c8_batches = [p010_batch(BATCH, SEED + 20 + i, dev)
                  for i in range(C8_SCENES)]
    k8 = {"max_abs_err": 0.0, "max_abs_err_variant": 0.0}
    k8_k9 = {"max_code_diff": 0, "frac_differing": 0.0}
    k8_digests = []
    two = tuple(p[:PLAIN_FRAMES] for p in c8_batches[0])
    for meta, key, tol in ((dovi_meta(), "max_abs_err", 1e-5),
                           (dovi_variant(), "max_abs_err_variant", 1e-4)):
        fn = make_serving_fn(plan_pipeline(*c8_args(meta)), pack_surface=True)
        scene = dovi_rt(2, meta)
        with recording(dk, "rows3_mid", "cols3_tail") as calls:
            fn(two, {"dovi_curves": scene})
        torch.cuda.synchronize()
        (a8, kw8, got8), = calls["rows3_mid"]
        if not np.array_equal(a8[6].curves, dovi.flatten_curve_scalars(
                scene, dovi.curve_structure(meta))):
            raise AssertionError("K8 was not given the scene's curves")
        ref8 = dk.rows3_mid_plain(*a8, **kw8)
        k8[key] = max((g - r).abs().max().item() for g, r in zip(got8, ref8))
        k8_digests.append(digest(*got8))
        if k8[key] > tol:
            raise AssertionError(f"K8 disagrees with its plain version: {k8}")
        (a9, kw9, got9), = calls["cols3_tail"]
        dd = code_diff(got9, dk.cols3_tail_plain(*a9, **kw9), 10)
        k8_k9 = {k: max(k8_k9[k], dd[k]) for k in k8_k9}
        k8_digests.append(digest(got9))
        del calls, a8, kw8, got8, ref8, a9, kw9, got9, fn
    if k8_k9["max_code_diff"] > 1 or k8_k9["frac_differing"] >= 0.02:
        raise AssertionError(f"c8's K9 disagrees with its plain version: "
                             f"{k8_k9}")
    line("K8", frames=PLAIN_FRAMES, route="runtime curves (scene 2)",
         tolerance="c8 f32 <= 1e-5, variant f32 <= 1e-4; K9 <= 1 code on "
                   "< 2%", k9_on_c8=k8_k9,
         digests_k8_k9=k8_digests, **k8)
    del two

    # 16. K3 at the letterboxed plan's shapes (the calls its K1 + K3
    #     route made before the offset tail; the placed route is K2's now
    #     and K3's path is the GRAY source's, phase 27): on PLAIN_FRAMES
    #     frames, each plane's K1 float32 output of the plan's maps (luma
    #     1608 -> 804 rows, chroma 804 -> 804 through the composed
    #     upsample), and raw uint16 luma with the normalisation in the
    #     taps
    src_b = SourceDescriptor(format=ColorFormat.P010, width=W, height=LB_H,
                             matrix=CSP.BT_2020_NC, levels=Levels.TV,
                             primaries=Primaries.BT_2020, transfer=TRC.PQ,
                             hdr10=HDR10Metadata())
    dst_b = OutputDescriptor(width=OW, height=OH, bits=10, video_rect=LB_RECT)
    set_b = Settings(upscaling=Upscaling.LANCZOS3, convert_to_sdr=True)
    lb_batches = [p010_batch(BATCH, SEED + 30 + i, dev, h=LB_H)
                  for i in range(2)]
    wx_b, wy_b, cwx_b, cwy_b, norm_b = fused_maps(
        plan_pipeline(set_b, src_b, dst_b))
    k3 = {"max_abs_err": 0.0}
    k3_outs = []
    for p, (kw3, kh3) in zip(lb_batches[0], (
            rk.mega_maps(wx_b, wy_b, norm_b),
            rk.mega_maps(cwx_b, cwy_b, norm_b),
            rk.mega_maps(cwx_b, cwy_b, norm_b))):
        x3 = rk.banded_resize_last_axis(p[:PLAIN_FRAMES], kw3)
        got = rk.banded_resize_rows(x3, kh3)
        torch.cuda.synchronize()
        k3["max_abs_err"] = max(k3["max_abs_err"], (
            got - rk.banded_resize_rows_plain(x3, kh3)).abs().max().item())
        k3_outs.append(got)
        del x3
    k3_digest = digest(*k3_outs)
    del k3_outs
    ky_raw = rk.BandedMatrix(scale.upscale_matrix(Upscaling.LANCZOS3, LB_H,
                                                  LB_RECT[3] - LB_RECT[1]),
                             pre_scale=norm)
    raw = lb_batches[0][0][:PLAIN_FRAMES]
    got = rk.banded_resize_rows(raw, ky_raw)
    torch.cuda.synchronize()
    k3["max_abs_err_u16"] = (got - rk.banded_resize_rows_plain(
        raw, ky_raw)).abs().max().item()
    k3_u16_digest = digest(got)
    del got, raw
    if max(k3.values()) > 2e-6:
        raise AssertionError(f"K3 disagrees with its plain version: {k3}")
    line("K3", frames=PLAIN_FRAMES, tolerance="f32 <= 2e-6",
         digest=k3_digest, u16_digest=k3_u16_digest, **k3)

    # 17. c8 served: one make_serving_fn, C8_SCENES scenes of batch 16 (each
    #     its own frames and curves), K1 x2 + K8 x1 + K9 x1 per call, no
    #     build or library load between scenes
    plan8 = plan_pipeline(*c8_args(dovi_meta()))
    serve = make_serving_fn(plan8, pack_surface=True)
    rts = [{"dovi_curves": dovi_rt(i)} for i in range(C8_SCENES)]
    # a call recorded for the kernels' times at c8's batch (also warm-up)
    with recording(dk, "rows3_mid", "cols3_tail") as calls:
        serve(c8_batches[0], rts[1])
    torch.cuda.synchronize()
    (a8, kw8, _), = calls["rows3_mid"]
    (a9, kw9, _), = calls["cols3_tail"]
    del calls
    lib_before, builds = build.load(), []
    real_build = build.build
    build.build = lambda: builds.append(1) or real_build()
    c8_times = []

    def c8_run():
        outs = []
        for b, rt in zip(c8_batches, rts):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(serve(b, rt))
            t1.record()
            torch.cuda.synchronize()
            c8_times.append(t0.elapsed_time(t1))
        return outs

    try:
        c8_outs, c8_launches = count_launches(c8_run)
    finally:
        build.build = real_build
    if c8_launches != only(banded_resize_last_axis=2 * C8_SCENES,
                           rows3_mid=C8_SCENES, cols3_tail=C8_SCENES):
        raise AssertionError(f"c8 launches {c8_launches}")
    if builds or build.load() is not lib_before:
        raise AssertionError("a scene change built or loaded the kernels")
    for o in c8_outs:
        if o.shape != (BATCH, OH, OW) or o.dtype != torch.int32:
            raise AssertionError(f"c8 output {tuple(o.shape)} {o.dtype}")
    db8 = {f"scene{i}": psnr(codes(c8_outs[i][0], 10).double() / 1023.0,
                             c8_oracle(c8_batches[i], dovi_meta(),
                                       rts[i]["dovi_curves"]))
           for i in (0, C8_SCENES - 1)}
    c8_digest = digest(*c8_outs)
    del c8_outs
    variant = dovi_variant()
    serve_v = make_serving_fn(plan_pipeline(*c8_args(variant)),
                              pack_surface=True)
    rt_v = dovi_rt(1, variant)
    with recording(dk, "rows3_mid") as calls:
        out_v = serve_v(c8_batches[1], {"dovi_curves": rt_v})
    (a8v, kw8v, _), = calls["rows3_mid"]
    del calls
    db8["variant"] = psnr(codes(out_v[0], 10).double() / 1023.0,
                          c8_oracle(c8_batches[1], variant, rt_v))
    del out_v, serve_v
    c8_ms = cuda_ms(lambda: [serve(b, rt) for b, rt in zip(c8_batches, rts)],
                    reps=1, warmup=0) / (C8_SCENES * BATCH)
    t8 = []
    for i in range(15):
        one = tuple(p[i:i + 1] for p in c8_batches[1])
        t0 = time.perf_counter()
        serve(one, rts[i % C8_SCENES])
        torch.cuda.synchronize()
        t8.append((time.perf_counter() - t0) * 1e3)
    serve_p = make_serving_fn(plan_pipeline(*c8_args(dovi_meta(), False)),
                              pack_surface=True)
    out_p = serve_p(c8_batches[0], rts[0])
    db8["plain"] = psnr(codes(out_p[0], 10).double() / 1023.0,
                        c8_oracle(c8_batches[0], dovi_meta(),
                                  rts[0]["dovi_curves"]))
    del out_p
    c8_plain_ms = cuda_ms(lambda: serve_p(c8_batches[0], rts[0]), reps=1,
                          warmup=0) / BATCH
    if min(db8.values()) < 55.0:
        raise AssertionError(f"c8 PSNR below 55 dB: {db8}")
    # K8 and K9 at c8's batch, on the recorded call's inputs
    k8["ms"] = cuda_ms(lambda: dk.rows3_mid(*a8, **kw8))
    k8["variant_ms"] = cuda_ms(lambda: dk.rows3_mid(*a8v, **kw8v))
    del a8v, kw8v
    k8["plain_ms"] = cuda_ms(lambda: dk.rows3_mid_plain(*a8, **kw8), reps=1)
    # operations: the in and out taps, the identity reshape (4 a channel)
    # and the matrix (18) per mid pixel
    k8.update(bound(tbytes(*a8[:3]) + 3 * BATCH * OH * W * 4
                    + mbytes(a8[3], a8[4], a8[7]),
                    2 * map_flops(a8[4], BATCH * W) + 30 * BATCH * H * W
                    + 3 * map_flops(a8[7], BATCH * W)), library_ms=None)
    k9_c8_ms = cuda_ms(lambda: dk.cols3_tail(*a9, **kw9))
    # the tail and the store alone, on OW-wide planes read directly
    direct9 = (*(p[..., :OW].contiguous() for p in a9[:3]), None, None, OW,
               a9[6])
    k9_c8_tail_ms = cuda_ms(lambda: dk.cols3_tail(
        *direct9, y_scale=1.0, c_scale=1.0, **kw9))
    del direct9
    # K9's bound at c8: the three float32 mid planes in, the RGB10 dwords
    # out, the shared W map's tap table once; operations: the W taps of the
    # three planes (no colour matrix: the planes are R, G, B)
    rows_c8 = a9[0].numel() // a9[0].shape[-1]
    k9_c8_bound = bound(
        tbytes(*a9[:3]) + rows_c8 * OW * 4 + mbytes(a9[3])
        + (0 if a9[4] is a9[3] else mbytes(a9[4])),
        map_flops(a9[3], rows_c8) + 2 * map_flops(a9[4], rows_c8))
    del a8, kw8, a9, kw9
    line("c8", batch=BATCH, scenes=C8_SCENES, launches=c8_launches,
         builds_between_scenes=len(builds), psnr_db=db8,
         ms_per_frame=c8_ms,
         ms_per_frame_synced=sum(c8_times) / (C8_SCENES * BATCH),
         ms_batch1_median=float(np.median(t8)),
         ms_batch1_p90=float(np.percentile(t8, 90)),
         plain_ms_per_frame=c8_plain_ms, k8_ms=k8["ms"],
         k8_variant_ms=k8["variant_ms"], k8_bound_ms=k8["bound_ms"],
         k9_ms=k9_c8_ms, k9_tail_ms=k9_c8_tail_ms,
         k9_bound_ms=k9_c8_bound["bound_ms"],
         k9_bound_by=k9_c8_bound["bound_by"], digest=c8_digest)
    del c8_batches, serve, serve_p
    torch.cuda.empty_cache()

    # 18. the letterboxed path: VideoProcessor 3840 x 1608 -> the 1920 x 804
    #     rect of a 1920 x 1080 RGB10 surface, two distinct batches of 16,
    #     K1 x3 + K2 x1 per call (K2 stores at the rect's origin); the rect
    #     bit-equal to the unplaced 1920 x 804 plan's surface, the bars
    #     exactly the packed zero; then a 4:3 film pillarboxed and a rect
    #     whose column offset is not a multiple of 4, on 2 frames
    vp_b = VideoProcessor(set_b, src_b, dst_b, device=dev, pack_surface=True)
    vp_b.process(lb_batches[0])                 # warm-up, before the count
    lb_times = []

    def lb_run():
        outs = []
        for b in lb_batches:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(vp_b.process(b))
            t1.record()
            torch.cuda.synchronize()
            lb_times.append(t0.elapsed_time(t1))
        return outs

    lb_outs, lb_launches = count_launches(lb_run)
    lb_digest = digest(*lb_outs)
    if lb_launches != only(banded_resize_last_axis=3 * len(lb_batches),
                           rows3_tail=len(lb_batches)):
        raise AssertionError(f"letterbox launches {lb_launches}")
    placed = {"letterbox": placed_check(
        lb_outs, lb_batches, LB_RECT,
        lambda b: VideoProcessor(set_b, src_b, OutputDescriptor(
            width=LB_RECT[2] - LB_RECT[0], height=LB_RECT[3] - LB_RECT[1],
            bits=10), device=dev, pack_surface=True).process(b))}
    l, tp, r, bt = LB_RECT
    want = oracle(*(p[0] for p in lb_batches[0]), OW, OH, video_rect=LB_RECT)
    got0 = codes(lb_outs[0][0], 10).double() / 1023.0
    db_lb = {"rect": psnr(got0[:, tp:bt, l:r], want[:, tp:bt, l:r]),
             "surface": psnr(got0, want)}
    del lb_outs, got0, want
    lb_ms = cuda_ms(lambda: [vp_b.process(b) for b in lb_batches], reps=1,
                    warmup=0) / (len(lb_batches) * BATCH)
    # a 4:3 film (PILLAR_W x H) pillarboxed, and the headline source into
    # ODD_RECT, each on PLAIN_FRAMES frames, with the same checks
    for key, w_src, rect in (("pillarbox", PILLAR_W, PILLAR_RECT),
                             ("odd_rect", W, ODD_RECT)):
        src_p = SourceDescriptor(format=ColorFormat.P010, width=w_src,
                                 height=H, matrix=CSP.BT_2020_NC,
                                 levels=Levels.TV, primaries=Primaries.BT_2020,
                                 transfer=TRC.PQ, hdr10=HDR10Metadata())
        two = p010_frames(PLAIN_FRAMES, SEED + 33, dev, w_src, H)
        out_p, n_p = count_launches(lambda: VideoProcessor(
            set_b, src_p, OutputDescriptor(width=OW, height=OH, bits=10,
                                           video_rect=rect),
            device=dev, pack_surface=True).process(two))
        if n_p != only(banded_resize_last_axis=3, rows3_tail=1):
            raise AssertionError(f"{key} launches {n_p}")
        placed[key] = placed_check(
            [out_p], [two], rect,
            lambda b: VideoProcessor(set_b, src_p, OutputDescriptor(
                width=rect[2] - rect[0], height=rect[3] - rect[1], bits=10),
                device=dev, pack_surface=True).process(b))
        want = oracle(*(p[0] for p in two), OW, OH, video_rect=rect)
        l, tp, r, bt = rect
        placed[key]["psnr_db_rect"] = psnr(
            (codes(out_p[0], 10).double() / 1023.0)[:, tp:bt, l:r],
            want[:, tp:bt, l:r])
        del two, out_p, want
    bars_black = all(c["bars_black"] for c in placed.values())
    rect_bit_equal = all(c["rect_bit_equal"] for c in placed.values())
    if not (bars_black and rect_bit_equal) or min(
            [*db_lb.values()] + [c["psnr_db_rect"] for k, c in
                                 placed.items() if k != "letterbox"]) < 55.0:
        raise AssertionError(f"letterbox: {placed}, PSNR {db_lb}")
    line("letterbox", batch=BATCH, calls=len(lb_batches),
         launches=lb_launches, bars_black=bars_black,
         rect_bit_equal=rect_bit_equal, psnr_db=db_lb, placed=placed,
         ms_per_frame=sum(lb_times) / (len(lb_batches) * BATCH),
         ms_per_frame_back_to_back=lb_ms, digest=lb_digest)
    del lb_batches, vp_b
    torch.cuda.empty_cache()

    k4, k4_launches = k4_phase(dev)

    # 20. c7 served: one make_serving_fn, C7_SCENES scenes of batch 16 (each
    #     its own frames and HDR10 values), K1 x2 + K2 x1 per call, no build
    #     or library load between scenes; the static route; the plain path
    plan7 = plan_pipeline(*c7_args())
    serve7 = make_serving_fn(plan7, pack_surface=True)
    c7_batches = [p010_batch(BATCH, SEED + 50 + i, dev)
                  for i in range(C7_SCENES)]
    rts7 = [c7_rt(i) for i in range(C7_SCENES)]
    # the path's K1 and K2 calls on PLAIN_FRAMES frames with scene 2's
    # values, each against its plain version on the same inputs
    with recording(rk, "banded_resize_last_axis", "rows3_tail") as calls:
        serve7(tuple(p[:PLAIN_FRAMES] for p in c7_batches[0]), rts7[2])
    torch.cuda.synchronize()
    k1_calls, k2_calls = calls["banded_resize_last_axis"], calls["rows3_tail"]
    if len(k1_calls) != 2 or len(k2_calls) != 1:
        raise AssertionError(f"c7 recorded {len(k1_calls)} K1 and "
                             f"{len(k2_calls)} K2 calls")
    c7k = {"k1_max_code_diff": max(
        int((got.float() - rk.banded_resize_last_axis_plain(*a, **kw).float())
            .abs().max().item()) for a, kw, got in k1_calls),
        "k1_digest": digest(*(o for _, _, o in k1_calls))}
    (a, kw, got), = k2_calls
    c7k["k2_digest"] = digest(got)
    if a[6].tonemap != ToneMapType.BT2390 or kw.get("pack_format") != "rgb10a2" \
            or a[3] is not None:
        raise AssertionError("c7: K2 tone map "
                             f"{a[6].tonemap}, pack {kw.get('pack_format')}, "
                             f"luma map {a[3]}")
    ref = rk.rows3_tail_plain(*a, **kw)
    c7k.update({"k2_" + k: x for k, x in code_diff(got, ref, 10).items()})
    c7k["k2_alpha_ok"] = bool(torch.equal(got >> 30, ref >> 30))
    del calls, k1_calls, k2_calls, a, kw, got, ref
    if c7k["k1_max_code_diff"] > 1 or c7k["k2_max_code_diff"] > 1 \
            or c7k["k2_frac_differing"] >= 0.02 or not c7k["k2_alpha_ok"]:
        raise AssertionError(f"c7's K1 or K2 disagrees with its plain "
                             f"version: {c7k}")
    # a call at batch 16, recorded for K2's time on c7's inputs (also the
    # warm-up)
    with recording(rk, "rows3_tail") as calls:
        serve7(c7_batches[0], rts7[1])
    torch.cuda.synchronize()
    (a2_7, kw2_7, _), = calls["rows3_tail"]
    del calls
    lib_before, builds = build.load(), []
    real_build = build.build
    build.build = lambda: builds.append(1) or real_build()
    c7_times = []

    def c7_run():
        outs = []
        for b, rt in zip(c7_batches, rts7):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(serve7(b, rt))
            t1.record()
            torch.cuda.synchronize()
            c7_times.append(t0.elapsed_time(t1))
        return outs

    try:
        c7_outs, c7_launches = count_launches(c7_run)
    finally:
        build.build = real_build
    if c7_launches != only(banded_resize_last_axis=2 * C7_SCENES,
                           rows3_tail=C7_SCENES):
        raise AssertionError(f"c7 launches {c7_launches}")
    if builds or build.load() is not lib_before:
        raise AssertionError("a scene change built or loaded the kernels")
    for o in c7_outs:
        if o.shape != (BATCH, H, W) or o.dtype != torch.int32:
            raise AssertionError(f"c7 output {tuple(o.shape)} {o.dtype}")
    db7 = {f"scene{i}": psnr(codes(c7_outs[i][0], 10).double() / 1023.0,
                             c7_oracle(c7_batches[i], rts7[i]["hdr"]))
           for i in (0, C7_SCENES - 1)}
    c7_digests = {"scenes": digest(*c7_outs)}
    del c7_outs
    # the static route: VideoProcessor, the plan's metadata (MaxCLL 3000,
    # display 600), the scalars from the host in float64
    vp7 = VideoProcessor(*c7_args(), device=dev, pack_surface=True)
    static_out, static_launches = count_launches(
        lambda: vp7.process(c7_batches[1]))
    if static_launches != only(banded_resize_last_axis=2, rows3_tail=1):
        raise AssertionError(f"c7 static launches {static_launches}")
    c7_digests["static"] = digest(static_out)
    db7["static"] = psnr(
        codes(static_out[0], 10).double() / 1023.0,
        c7_oracle(c7_batches[1], {"max_cll": 3000.0, "display_max_nits": 600.0,
                                  "mastering_max_nits": 4000.0}))
    del static_out, vp7
    c7_ms = cuda_ms(lambda: [serve7(b, rt) for b, rt in zip(c7_batches, rts7)],
                    reps=1, warmup=0) / (C7_SCENES * BATCH)
    t7 = []
    for i in range(15):
        one = tuple(p[i:i + 1] for p in c7_batches[1])
        t0 = time.perf_counter()
        serve7(one, rts7[i % C7_SCENES])
        torch.cuda.synchronize()
        t7.append((time.perf_counter() - t0) * 1e3)
    serve7p = make_serving_fn(plan_pipeline(*c7_args(accel=False)),
                              pack_surface=True)
    out_p = serve7p(c7_batches[0], rts7[0])
    db7["plain"] = psnr(codes(out_p[0], 10).double() / 1023.0,
                        c7_oracle(c7_batches[0], rts7[0]["hdr"]))
    del out_p
    c7_plain_ms = cuda_ms(lambda: serve7p(c7_batches[0], rts7[0]), reps=1,
                          warmup=0) / BATCH
    if min(db7.values()) < 55.0:
        raise AssertionError(f"c7 PSNR below 55 dB: {db7}")
    k2_c7 = {"k2_ms": cuda_ms(lambda: rk.rows3_tail(*a2_7, **kw2_7))}
    # K2 at c7: raw luma, the mid16 chroma and the packed surface; the
    # chroma H taps and the matrix (not the tone map's pows)
    k2_c7.update({"k2_" + k: x for k, x in bound(
        tbytes(*a2_7[:3]) + BATCH * H * W * 4 + mbytes(a2_7[4]),
        2 * map_flops(a2_7[4], BATCH * W) + 18 * BATCH * H * W).items()})
    del a2_7, kw2_7
    line("c7", batch=BATCH, scenes=C7_SCENES, launches=c7_launches,
         builds_between_scenes=len(builds), psnr_db=db7,
         ms_per_frame=c7_ms,
         ms_per_frame_synced=sum(c7_times) / (C7_SCENES * BATCH),
         ms_batch1_median=float(np.median(t7)),
         ms_batch1_p90=float(np.percentile(t7, 90)),
         plain_ms_per_frame=c7_plain_ms, **k2_c7, digests=c7_digests,
         kernels_frames=PLAIN_FRAMES,
         tolerance="K1 mid16 <= 1 code; K2 <= 1 code on < 2% of channels",
         **c7k)
    del c7_batches, serve7, serve7p
    torch.cuda.empty_cache()

    # 21. the probe: K10 against its plain versions on PLAIN_FRAMES headline
    #     frames (the luma W map of the fused plan, its normalisation
    #     folded in); then at batch 16 torch_headline_micro.py's W-pass
    #     probe and its stage split of the headline and of c7, each counted.
    #     (Imported here: it imports this file's helpers as chip_smoke.)
    import torch_headline_micro as thm
    wx10, _, _, _, norm10 = fused_maps(thm.plan_for("headline"))
    kw10 = rk.BandedMatrix(wx10, pre_scale=norm10)
    y16 = p010_batch(BATCH, SEED + 60, dev)[0]
    y2 = y16[:PLAIN_FRAMES]
    got = pk.wpass_floor(y2, OW)
    torch.cuda.synchronize()
    k10f = {"bit_equal": bool(torch.equal(got, pk.wpass_floor_plain(y2, OW))),
            "max_abs_err": 0.0}
    got = pk.wpass_bf16(y2, kw10)
    torch.cuda.synchronize()
    k10 = {"max_abs_err": (got - pk.wpass_bf16_plain(y2, kw10)).abs().max()
           .item(), "digest": digest(got)}
    del got, y2
    if not k10f["bit_equal"] or k10["max_abs_err"] > 1e-5:
        raise AssertionError(f"K10 disagrees with its plain versions: "
                             f"floor bit-equal {k10f['bit_equal']}, bf16 "
                             f"{k10['max_abs_err']}")
    runs = thm.REPS + 1                      # cuda_ms: a warm-up, then REPS
    probe_ms, probe_launches = count_launches(
        lambda: thm.time_stages(thm.wpass_probe(y16, kw10)))
    if probe_launches != only(banded_resize_last_axis=runs, wpass_bf16=runs,
                              wpass_floor=runs):
        raise AssertionError(f"the W-pass probe launched {probe_launches}")
    k10["ms"], k10f["ms"] = probe_ms["yW1"], probe_ms["yWsplit"]
    k10["plain_ms"] = cuda_ms(lambda: pk.wpass_bf16_plain(y16, kw10))
    k10f["plain_ms"] = cuda_ms(lambda: pk.wpass_floor_plain(y16, OW))
    # the luma read once, float32 out written once (bf16 taps); operations:
    # the band's bf16 products, at the tensor cores' bf16 rate
    rows10 = y16.numel() // W
    io10 = tbytes(y16) + rows10 * OW * 4
    k10.update(bound(io10 + kw10.starts.nbytes + kw10.taps.nbytes // 2,
                     map_flops(kw10, rows10), PEAK_BF16_S))
    k10f.update(bound(io10, 0), library_ms=None)
    # the library call: one float32 product of the pre-rounded operands
    xb = y16.float().to(torch.bfloat16).float()
    mb = kw10.dense_on(dev).to(torch.bfloat16).float()
    k10["library_ms"] = cuda_ms(lambda: torch.matmul(xb, mb))
    del xb, mb, y16
    torch.cuda.empty_cache()
    split, split_launches = {}, {}
    for key, seed in (("headline", SEED + 61), ("c7", SEED + 62)):
        planes = p010_batch(BATCH, seed, dev)
        fns = thm.stages(thm.plan_for(key), planes)
        f16 = make_frame_fn(thm.plan_for(key, TexFormat.FLOAT16),
                            pack_surface=True)
        if not torch.equal(fns["tail"](), f16(planes)):
            raise AssertionError(f"probe {key}: tail on the W stages is not "
                                 "the FLOAT16 frame function")
        digests = {k: digest(*(o if isinstance(o, tuple) else (o,)))
                   for k, o in ((k, f()) for k, f in fns.items())}
        torch.cuda.synchronize()
        ms, n = count_launches(lambda: thm.time_stages(fns))
        n_w = 3 if "yW" in fns else 2        # W passes of one full call
        if n != only(banded_resize_last_axis=2 * n_w * runs,
                     rows3_tail=5 * runs):
            raise AssertionError(f"probe {key}: the stages launched {n}")
        split[key] = {"ms_per_frame": {k: v / BATCH for k, v in ms.items()},
                      **{k: v for k, v in thm.attribution(ms, BATCH).items()
                         if k != "summary"},
                      "tail_bit_equal_float16": True, "digests": digests}
        split_launches[key] = n
        del planes, fns, f16, digests
        torch.cuda.empty_cache()
    line("probe", batch=BATCH, frames=PLAIN_FRAMES,
         tolerance="wpass_floor bit-equal, wpass_bf16 <= 1e-5; tail == the "
                   "FLOAT16 make_frame_fn",
         wpass_floor_bit_equal=k10f["bit_equal"],
         wpass_bf16_max_abs_err=k10["max_abs_err"],
         wpass_bf16_digest=k10["digest"],
         wpass_ms_per_frame={k: v / BATCH for k, v in probe_ms.items()},
         wpass_launches={k: v for k, v in probe_launches.items() if v},
         memcpy_note=thm.MEMCPY_NOTE, stages=split,
         stage_launches={p: {k: v for k, v in n.items() if v}
                         for p, n in split_launches.items()})

    # 22-28: the strong downscales, Dolby Vision in a rect, the SDR
    # BT.2020 fix, GRAY and the shader order
    new = offset_tail_phases(dev)
    # 29-31: HDR10+ (the guided curve) and the Dolby Vision extension
    # blocks (the L2 trims), on K2's and K9's runtime routes
    hdr = hdr_dynamic_phases(dev)
    # 32-35: c5s and the headline through the renderer facade, device
    # ingest and the clip runner
    ren = renderer_phases(dev, ms_field)
    # 36-38: the learned models (c3sr, c1vh) and the command line
    mc = model_cli_phases(dev)
    # 39-42: training, data parallelism and the train commands
    tr = train_phases(dev)
    # 43-48: parallel/spatial: c6, four shards of c6 on the card, c9, the
    # Dolby Vision, learned and Jinc2 forms
    spa = spatial_phases(dev)
    # 49-50: c2 and c4
    cov = coverage_phases(dev)
    # 51: c8 through the two-stage Dolby Vision form
    ts = two_stage_phase(dev)

    def new_launches(name):
        return sum(n[name] for phases in (new, hdr, ren, mc, tr, spa, cov, ts)
                   for n in phases["launches"].values())

    def entry(name, source, replaces, n, k, err):
        return {"name": name, "route": "cuda",
                "source": f"videorenderer_tpu_torch/csrc/{source}",
                "replaces": f"videorenderer_tpu/kernels/{replaces}",
                "launches": n, "max_abs_err": err, "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    def k10_entry(name, form, k):   # K10 replaces the bench script's kernel
        return {**entry(name, "probe_wpass.cu", "", probe_launches[form], k,
                        k["max_abs_err"]),
                "replaces": "bench_headline_micro.py:113"}

    kernels = [
        entry("banded_resize_last_axis", "banded_resize.cu",
              "resize_pallas.py:261",
              launches["banded_resize_last_axis"]
              + c8_launches["banded_resize_last_axis"]
              + lb_launches["banded_resize_last_axis"]
              + c7_launches["banded_resize_last_axis"]
              + probe_launches["banded_resize_last_axis"]
              + sum(n["banded_resize_last_axis"]
                    for n in split_launches.values())
              + new_launches("banded_resize_last_axis"), k1,
              max(k1["max_abs_err"], conv["k1_max_abs_err"],
                  sr_k["k1_max_abs_err"], new["err"]["k1"],
                  hdr["err"]["k1"], mc["err"]["k1"], spa["err"]["k1"],
                  cov["err"]["k1"], ts["err"]["k1"])),
        {**entry("rows3_tail", "rows3_tail.cu", "resize_pallas.py:834",
                 launches["rows3_tail"] + c7_launches["rows3_tail"]
                 + sum(n["rows3_tail"] for n in split_launches.values())
                 + lb_launches["rows3_tail"] + new_launches("rows3_tail"),
                 k2, max(k2["max_abs_err"], conv["k2_max_abs_err"],
                         sr_k["k2_max_abs_err"],
                         c7k["k2_max_code_diff"] / 1023.0, new["err"]["k2"],
                         hdr["err"]["k2"], mc["err"]["k2"],
                         cov["err"]["k2"], ts["err"]["k2"])),
         # the runtime route (selection 7) at c7p, batch 16
         "runtime_route": hdr["runtime"]["rows3_tail"],
         # the Dolby Vision route (stage A of the two-stage form) at c8,
         # batch 16, its launches phase 51's
         "dovi_route": entry("rows3_tail_dovi", "rows3_tail_dovi.cu",
                             "resize_pallas.py:834",
                             new_launches("rows3_tail_dovi"), ts["k2_dovi"],
                             ts["err"]["k2_dovi"])},
        entry("mega3_tail", "mega3_tail.cu", "resize_pallas.py:704",
              k4_launches["mega3_tail"], k4,
              k4["max_abs_err"]),
        {**entry("banded_resize_rows", "banded_resize_rows.cu",
                 "resize_pallas.py:340", new_launches("banded_resize_rows"),
                 new["k3"], max(k3["max_abs_err"], k3["max_abs_err_u16"],
                                new["k3"]["max_abs_err"], spa["err"]["k3"])),
         "k3_route": new["k3"]["route"],
         # the per-shard form (an inner shard of phase 44's four, each its
         # own table), in place of the stacked band tables
         "per_shard": {**entry(
             "banded_resize_rows", "banded_resize_rows.cu",
             "resize_pallas.py:355",
             sum(n["banded_resize_rows"] for k, n in spa["launches"].items()
                 if k.startswith("c6x")),
             spa["k3_shard"], spa["k3_shard"]["max_abs_err"]),
             "k3_route": spa["k3_shard"]["route"]}},
        {**entry("jinc2_resize_fused", "jinc2_resize.cu",
                 "jinc2_pallas.py:242", r270_launches["jinc2_resize_fused"]
                 + new_launches("jinc2_resize_fused"),
                 k5, max(k5["max_abs_err"], spa["err"]["k5"])),
         "k5_route": k5["route"],
         "table_launches": r270_first["jinc2_weight_table"]},
        {**entry("jinc2_convert_fused", "jinc2_convert.cu",
                 "jinc2_pallas.py:705",
                 c3_launches["jinc2_convert_fused"]
                 + rot_launches["jinc2_convert_fused"]
                 + new_launches("jinc2_convert_fused"), k6,
                 k6["max_abs_err"]),
         # the table kernel's launches: the first calls of c3, c3rot and
         # c3 rotation 270 (K5's, where its table route builds one)
         "table": k6t and entry(
             "jinc2_weight_table", "jinc2_convert.cu", "jinc2_pallas.py:705",
             c3_first["jinc2_weight_table"]
             + rot_first["jinc2_weight_table"]
             + r270_first["jinc2_weight_table"], k6t, k6t["max_abs_err"])},
        entry("deint3_rows_dual", "deint3_rows_dual.cu", "deint_pallas.py:86",
              c5_launches["deint3_rows_dual"]
              + new_launches("deint3_rows_dual"), k7,
              max(k7["max_abs_err"], new["err"]["k7"])),
        entry("rows3_mid", "rows3_mid.cu", "deint_pallas.py:216",
              c8_launches["rows3_mid"] + new_launches("rows3_mid"), k8,
              max(k8["max_abs_err"], k8["max_abs_err_variant"],
                  new["err"]["k8"], hdr["err"]["k8"])),
        {**entry("cols3_tail", "cols3_tail.cu", "deint_pallas.py:434",
                 c5_launches["cols3_tail"] + c8_launches["cols3_tail"]
                 + new_launches("cols3_tail"), k9,
                 max(k9["max_abs_err"], k8_k9["max_code_diff"] / 1023.0,
                     new["err"]["k9"], hdr["err"]["k9"])),
         # the runtime route (the L2 trims) at c8x and c8hdr, batch 16
         "runtime_route": hdr["runtime"]["cols3_tail"]},
        {**k10_entry("probe_wpass", "wpass_bf16", k10),
         "forms": {f: k10_entry(f, f, k) for f, k in (("wpass_bf16", k10),
                                                      ("wpass_floor", k10f))}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
