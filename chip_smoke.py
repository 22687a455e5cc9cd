#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (maskrcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit (nvidia-smi); every CUDA kernel of the
     port built from maskrcnn_tpu_torch/csrc by nvcc, and the host mask
     rasterizer by the C++ compiler, one process per source, all started
     together, with ptxas's register and spill report.
Serving:
  2. the flagship Mask R-CNN R-50-FPN at full width from the port's seeded
     init, bfloat16 compute. ROI_HEADS.SCORE_THRESH is lowered to 0: random
     weights give near-uniform class scores below the default 0.05, and the
     mask head should pool real boxes;
  3. four requests of COCO-like sizes after one warm-up, through
     Predictor.compute_prediction, each with its latency;
  4. the launch counts of that run: NMS twice and ROIAlign twice a request,
     no matcher and no ROIAlign backward;
  5. each kernel against its plain PyTorch version on the inputs the main
     path fed it in the first request, timed with CUDA events beside the
     least time the card could take for the same work (NMS also launch by
     launch under torch.profiler);
  6. the outputs: finite and of the expected shapes, and the same weights in
     float32 on a small image agreeing between the card (kernels) and the
     CPU (plain versions).
Training (a second model instance):
  7. the flagship at full width, bfloat16 compute, on bench.py's synthetic
     batch (8 images of 800x1344, COCO-like gt), SGD from the port's solver:
     one warm-up step, one counted step, then timed steps, each step's
     losses finite; trainable parameters moved, frozen ones (stem, layer1)
     did not;
  8. the launch counts of the counted step: matcher 1, NMS 1, ROIAlign
     forward 2, the default "roi" ROIAlign backward 2;
  9. each kernel against its plain version on the inputs that step fed it,
     timed beside its bound (NMS and the matcher also launch by launch); the
     three ROIAlign backwards ("roi", "rmw", "chunk") each on the gradients
     that step gave the two poolers, two calls of each giving the same bits;
 10. one float32 step on a small batch, the same weights and sampler draws
     on the card (kernels) and on the CPU (plain versions): losses and a
     handful of gradients agree; then again with the "rmw" backward at P=7
     and "chunk" at P=14;
 11. training img/s and MFU (maskrcnn_tpu_torch/utils/flops.py: FLOPs of one
     step from FlopCounterMode against the card's dense bf16 peak, 989
     TFLOP/s for the H100 SXM), the step's peak memory, and a
     torch.profiler breakdown of one step's device time, with the default
     "roi" backward and again with "rmw" at P=7 and "chunk" at P=14: the
     launch counters show the backward each run was given ("roi" twice a
     step; "rmw" and "chunk" once each), two tile launches a step, no
     scatter, no cast, and no memset asked for by the ROIAlign path.
The training entry point (a third model instance):
 12. a synthetic COCO-format tree of 32 images of 480x640 from the seed,
     with bench.py's gt statistics and polygon masks; the images are handed
     to COCODataset by overriding its _load_image (the card's machine has
     no image decoder); MODEL.WEIGHT, the seeded flagship with frozen-BN
     statistics from 8 of the images;
 13. python -m maskrcnn_tpu_torch.tools.train_net's main, in-process, on the
     flagship at full width (its keys as KEY VALUE overrides: no YAML on the
     card), batch 8 at 800x1333, 4 DataLoader workers, 8 iterations with a
     checkpoint every 4, MASKRCNN_POOLER_BWD_P7=rmw and _P14=chunk: launches
     per step (matcher 1, NMS 1, ROIAlign forward 2, "rmw" 1, "chunk" 1,
     "roi" 0), the logged iterations, the checkpoint files, finite losses,
     s/iter, img/s, the share of the time spent waiting for the loader, and
     the loader's own rate at these settings (24 batches past its first);
 14. a resumed run to 12 without --skip-test, SOLVER.TEST_PERIOD 4 and an
     8-image val tree: it loads model_final, starts from the saved
     parameters, logs no iteration below 9, validates (bbox) after
     iteration 12 and runs the final test (bbox, segm), by its log lines.
Evaluation (a fourth model instance):
 15. a synthetic COCO val tree of 32 images from the seed, 16 of 480x640
     then 16 of 640x480 (each test batch fills one of the two image
     buckets), over COCO's 80 sparse category ids; MODEL.WEIGHT, the seeded
     flagship with frozen-BN statistics from 8 of the images;
 16. python -m maskrcnn_tpu_torch.tools.test_net's main, in-process, on the
     flagship at full width (bf16), TEST.IMS_PER_BATCH 8 at 800x1333,
     SCORE_THRESH 0, 4 DataLoader workers, bbox and segm: NMS and ROIAlign
     twice a batch and nothing else, the model's and the total s/img (the
     inference log lines), the seconds of prepare_for_coco_segmentation and
     of each COCOEvaluator.evaluate, the AP dicts;
 17. NMS and the ROIAlign forward against their plain versions on the
     first test batch's inputs (RPN 40x1000, box post-process 640x200,
     8000 ROIs at P=7, 800 at P=14), timed beside their bounds;
 18. a known answer: the first pass's detections, resized here to their
     images' original sizes with their JSON category ids, become the tree's
     gt (those under 1 px a side counted); a second pass on the same
     images and weights (boxes only) must give the same detections (scores
     1e-5, boxes 1e-3 px) and bbox AP50 >= 0.99;
 19. the card against the CPU in float32 on a test batch of two images of
     different sizes, through detections_to_boxlists: 90% of each image's
     detections with a partner (label exact, score 1e-4, box 1e-2 px, mask
     1e-3, as phase 6), the share at scores 1e-5 and boxes 1e-3 px
     reported.
Multi-card (two ranks of a gloo group on the one card, this script's own
worker processes: python3 chip_smoke.py --worker ...; NCCL does not take two
ranks on one device):
 20. float32, the flagship at full width on a batch of two 320x480 images
     (the second at half the amplitude, the RPN objectness weights 20x for
     spread scores), one image a rank, the same weights and the global
     batch's draws: one SGD step against the one-process step on both
     images (losses 1e-5 relative, parameters within 2e-4 of the step's
     max|change|), both ranks' parameters bitwise equal, and the proposals
     each rank keeps under the global FPN k-th score against under its own;
 21. bf16, the flagship at global batch 8 (4 images of bench.py's batch a
     rank), 3 steps: launches per rank (matcher 1, NMS 1, ROIAlign forward
     2, "roi" backward 2 a step), finite losses, bitwise-equal parameters;
     each kernel against its plain version at the per-rank shapes (NMS
     20x2000, the matcher on 4 x 268,569 anchors, ROIAlign 2048 ROIs at P=7
     and 512 at P=14, the backward), rank by rank; the per-rank step time,
     the gradient all-reduce's time (176.5 MB through gloo) and the
     gathered FPN top-k's;
 22. train_net under the two ranks on phase 12's tree, global batch 8: 4
     iterations with a checkpoint at 4 (written by rank 0 only), then a
     resume to 6 on both ranks without --skip-test on the 8-image val tree
     (sharded test loaders: rank 0 gathers every image once, rank 1
     returns None); then phase 18's known answer through test_net under two
     ranks, phase 18's batches of 8 on each: bbox AP50 >= 0.99;
 23. NCCL at world size 1: train_net for 2 iterations in a process made
     from a torchrun-style environment (init_distributed makes the NCCL
     group; the step's collectives and the broadcast run through it), then
     the gradient all-reduce and the broadcast timed.
The model mesh axis (after 23: output-channel tensor parallelism over
TPU.MESH_AXES ("data", "model"), this script's gloo workers on the one card;
each rank's weights hold its block of the output channels, each conv and fc
gathers its whole weight over the model group at use):
 41. phase 20's batch and weights on (data 1, model 2), in the same two
     workers after 22, both images on both ranks: in bf16 (the flagship's
     dtype) the FPN features and one SGD step's losses against a
     one-process bf16 step, bit for bit (the mesh runs one process's ops on
     the same whole weights); in float32 one SGD step against the
     one-process step (losses 1e-5 relative, the gathered parameters
     within 2e-4 of the step's max|change|), fc6's block [512, 12544] on
     each rank, the replicated leaves bitwise equal on both, and a
     checkpoint written under the mesh by rank 0 at the full layout (equal
     to the gathered model, within 2e-4 of the step of one process's,
     momentum included);
 42. bf16, the flagship on (data 2, model 2), four ranks, at global batch 8
     (bench.py's, 4 images a data coordinate), 3 steps: launches per rank
     (matcher 1, NMS 1, ROIAlign forward 2, "roi" backward 2 a step), finite
     losses, the replicated leaves bitwise equal on all four ranks and the
     blocks across each data group; each kernel against its plain version
     at the per-rank shapes, rank by rank; the per-rank step times, the
     last step's collectives timed and their bytes by group (the model
     group's weight gathers, the data group's), the gradient all-reduce
     alone, the parameters' and
     momentum's bytes beside a data-only rank's, peak memory;
 43. train_net under (data 2, model 2) on phase 12's tree, global batch 8:
     4 iterations with a checkpoint at 4 (written by rank 0 only, gathered
     over its model group), a resume to 6 without --skip-test that
     validates at 6 and runs the final test on the sharded model (each val
     image gathered once, from model coordinate 0); model_final.pth read in
     one process equal to the model the ranks gathered; then phase 18's
     known answer through test_net under the mesh in bf16, phase 18's
     batches of 8 on each data coordinate: bbox AP50 >= 0.99.
The published configs as written (in-process, no download: urllib's
retrieve raises; weights from catalog:// names in a local cache, the
MASKRCNN_TPU_CACHE of the phase; data handed over in memory):
 24. train_net --config-file configs/e2e_mask_rcnn_R_50_FPN_1x.yaml, only
     SOLVER.MAX_ITER 4, OUTPUT_DIR and --skip-test given: batch 16 on two
     synthetic COCO trees at the catalog's coco_2014_train and
     coco_2014_valminusminival (a ConcatDataset of their 24 + 16 images),
     from a synthetic Detectron R-50.pkl (the seeded body, frozen BN
     calibrated on 8 images, each block's last BN and its shortcut's at
     weight R50_RESIDUAL_SCALE, written as Detectron's affine pairs, an
     fc1000, _momentum blobs): the body's tensors equal the blobs bit for
     bit, the loader's count printed, the FPN and heads at their init,
     every iteration's losses finite, each iteration's solver (both
     parameter groups' rate, weight decay and momentum) the config's
     schedule computed here, only the stem and layer1 frozen; NMS
     (80x2000), the matcher (16 x 268,569 anchors), the forward (P=7,
     P=14) and the "roi" backward against their plain versions on the
     run's first step, the matcher's phases from its own clock;
     then a synthetic Detectron model_final.pkl of a seeded,
     calibrated Mask R-CNN served by Predictor from
     catalog://Caffe2Detectron/COCO/35858933/e2e_mask_rcnn_R-50-FPN_1x:
     every tensor equal to the seeded model's (the frozen BN's running
     statistics, which Detectron does not store, at 0 and 1 in both), the
     detections of two requests equal, and another baseline's name on
     another cache file;
 25. configs/cityscapes/e2e_mask_rcnn_R_50_FPN_1x_poly.yaml as written
     (batch 8, short side 800-1024, long side 2048) for 3 iterations on a
     synthetic gtFine tree of 16 + 8 frames of 2048x1024 with 20-39
     instances each, then test_net on cityscapes_poly_instance_val through
     the Cityscapes evaluator (its AP tables printed) and the evaluator's
     known answer (the val instances as detections: AP50 >= 0.99); the
     losses and solver checked as in 24; the kernels as in 24 (NMS 40x2000,
     the matcher 8 x 523,776 anchors, P2 256x512);
 26. configs/cityscapes/e2e_mask_rcnn_R_50_FPN_1x_binarymask.yaml (batch
     16, 800x1333) for 2 iterations on the concatenation
     cityscapes_mask_instance_train + _val (binary masks from the
     instance-id images), ColorJitter 0.2 / 0.2 / 0.2 / 0.05: the loader's
     wait printed, the losses, the solver and the kernels (16 images) as in
     24;
 27. test_net with configs/e2e_faster_rcnn_R_50_FPN_1x.yaml at 21 classes
     on a synthetic VOC2007 test split of 16 images through the VOC
     evaluator, then its known answer (the first pass's detections as the
     gt: mAP >= 0.99).
The other model families as written (after 27, on its trees and cache):
 28. RetinaNet serving: configs/retinanet/retinanet_R-50-FPN_1x.yaml (bf16,
     INFERENCE_TH 0: random heads score near the prior's 0.01) through
     Predictor from the cache's R-50.pkl: four requests after a warm-up,
     each with its latency, one NMS launch a request and nothing else, NMS
     exact on the captured [1, 1000] class-offset lane (coordinates to
     ~8e5), and a float32 request card against CPU (the head redrawn so that
     its scores spread) at phase 6's tolerances;
 29. train_net with the RetinaNet YAML, only SOLVER.MAX_ITER 3, OUTPUT_DIR
     and --skip-test given: batch 16 on phase 24's trees, the matcher once a
     step and nothing else, losses and solver as in 24, the matcher exact on
     the first step's [16 x 201,600] anchors at 0.5 / 0.4, the step's time
     and peak memory and its device time split by torch.profiler (the head,
     the focal loss, the matcher, the rest); then test_net on the YAML's
     coco_2014_minival (16 images, TEST.IMS_PER_BATCH 8, bbox only), NMS
     exact on its two [8, 1000] lanes, and a known answer (the first pass's
     detections as gt: bbox AP50 >= 0.99);
 30. configs/e2e_faster_rcnn_R_101_FPN_1x.yaml through train_net for 3
     iterations at batch 16 from a synthetic R-101.pkl: matcher, NMS, the
     forward and the "roi" backward once a step, no mask head; losses,
     solver and kernels as in 24; then test_net on 8 images.
Keypoint R-CNN as written (after 30, on phase 24's images and cache):
 31. configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml through train_net, only
     SOLVER.MAX_ITER 3, OUTPUT_DIR and --skip-test given: batch 16 on its
     two keypoint trees (phase 24's images, 1-4 persons an image with 17
     joints, at least 10 visible), 8 x 512 keypoint convs, 56x56
     heatmaps; matcher 1, NMS 1, ROIAlign forward 2 (box, keypoint) and
     "roi" backward 2 a step; losses (loss_kp among them) and solver as
     in 24; the kernels of the first step against their plain versions,
     the keypoint site's forward (512 ROIs, P=14) and backward among them;
     the step's time and peak memory; then test_net on
     keypoints_coco_2014_minival (8 images, TEST.IMS_PER_BATCH 8,
     SCORE_THRESH 0, bbox and keypoints) through the exact host decode,
     its seconds an image, and a known answer (each image's first 20
     detections and their decoded joints as gt: keypoint AP50 >= 0.99);
     then Predictor from the YAML: four requests with keypoints on the
     original image, and a float32 request card against CPU with the
     heads redrawn so that scores and heatmaps spread (90% of the
     detections paired at label, score 1e-5 and box 1e-3 px; 99% of their
     joints within 1 px).
The GN and C4 families as written (after 31, on phase 24's trees and cache):
 32. configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml through
     train_net for 3 iterations at batch 16 from a synthetic
     catalog:// R-50-GN.pkl (the seeded GN body, Detectron's _gn_s / _gn_b
     blobs; its tensors equal the blobs): matcher 1, NMS 1, ROIAlign
     forward 2 and "roi" backward 2 a step, held to their plain versions on
     the first step; the group norm kernels 69 forward and 58 backward a
     step (69 forward a test batch and a request), held to group_norm_plain
     at the cell's shapes in bf16 and float32 (group_norm_sites: forward
     within 1e-5 or one bf16 ulp of max|y|, gradients within 1e-5 / 1e-2
     of max|grad|, two calls giving the same bits) and timed beside their
     bound; the step's time, device busy, idle share and peak memory, and
     the group norms' share of its device time; test_net on 8
     images and its known answer (the detections' boxes and pasted masks as
     gt: bbox and segm AP50 >= 0.99); one Predictor request; float32 card
     vs CPU (phase 6's gate);
 33. configs/e2e_mask_rcnn_R_50_C4_1x.yaml through train_net for 3
     iterations at batch 8 from the cache's R-50.pkl (res5 into the box
     head): matcher 1, NMS 1, and the ROIAlign kernels' adaptive instances
     (forward 2, "roi" backward 2) a step; NMS exact on the first step's
     [8 x 12000] lanes with its kernel-alone time, the matcher exact; the
     box (4096 ROIs) and mask poolers' adaptive kernels on the first step's
     inputs against the float32 gather path, the forward within 1e-5 of
     its max (float32) or 1e-2 of max|x| (bf16), the backward on the
     gradients the step gave them against the gather path's autograd
     within 1e-5 / 1e-2 of max|grad|, two calls of each giving the same
     bits, timed beside their bounds and the plain adaptive pooler (what
     CPU tensors run); the step's time, device busy, idle share, peak
     memory and the res5 head's share (forward and backward on the step's
     4096 box ROIs); test_net with the known answer, its first batch's box
     and mask poolers held and timed the same way (forward), and one
     Predictor request; then
     configs/quick_schedules/e2e_faster_rcnn_R_50_C4_quick.yaml through
     test_net alone at a short side of 480.
The last three families as written (after 33, on phase 24's trees and cache):
 34. RPN-only: configs/rpn_R_50_FPN_1x.yaml through train_net for 3
     iterations at batch 16 from the cache's R-50.pkl: the matcher once a
     step and nothing else (no proposals, no NMS), two losses, the solver
     as in 24, the matcher exact on the first step; test_net on 16 images
     (box-proposal recall AR@100 / AR@1000), the RPN's NMS exact on both
     batches' [40 x 1000] lanes, then a known answer (each image's 20 first
     proposals as gt: AR@100 and AR@1000 >= 0.99); one Predictor request
     (the proposals); configs/rpn_R_50_C4_1x.yaml through test_net on 8
     images, NMS exact on its [8 x 6000] lanes;
 35. deformable convs: configs/dcn/e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml
     through train_net for 3 iterations at batch 16 (cut to 8, then 4, only
     where the card runs out of memory, printed), the R-50.pkl into the
     body with the 26 offset-conv tensors at their zero init; the four
     kernels held to their plain versions on the first step as in 24; the
     step's time, device busy, peak memory and the deformable blocks' share
     (function_shares); test_net with a bbox and segm known answer; the v1
     Faster file through test_net on 8 images; a deformable v2 bottleneck
     of layer2's widths with offsets of about a cell, float32 card against
     CPU (output 1e-5, every gradient 2e-4 of its max);
 36. FBNet: configs/e2e_mask_rcnn_fbnet.yaml through train_net for 2
     iterations at SOLVER.IMS_PER_BATCH 16 (the published 128 over 8
     cards), from the seeded model with each frozen BN set from 8 images
     (the file names no weights): matcher 1 and NMS 1 a step, both exact
     on the first step's [16 x 12000] anchors (the 320x640 bucket's 20 x 40
     cells) and [16 x 6000] lanes, and the ROIAlign kernels' adaptive
     instances (forward 2, "roi" backward 2) a step, held to the gather
     path forward and backward on the first step's box and mask calls as
     in 33; nothing frozen; the step's time and peak memory; test_net with a bbox and segm
     known answer; e2e_faster_rcnn_fbnet_chamv1a_600.yaml and
     e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml served once each (frozen BN
     set from the warm-up image), the latter float32 card against CPU
     (phase 6's gate).
Test-time augmentation, the demo, the zoo gate and polygons (phase 24's
trees and cache):
 37. configs/test_time_aug/e2e_mask_rcnn_R_50_FPN_1x.yaml as written (800,
     then 400-1200 at MAX_SIZE 2000, each flipped: 18 passes an image) from
     the cache's R-50 through inference(bbox_aug_cfg=cfg) on 4 images of
     480x640 and 4 of 640x480: NMS and ROIAlign forward 36 times an image,
     s/img split into host preprocessing, model and merge, peak memory;
     both kernels against their plain versions at the largest (1216x1600)
     and smallest (416x544) pass; a known answer on the 8 images (their
     merged detections as gt: AP50 >= 0.99); float32 card against CPU on a small image at
     reduced scales; test_net with TTA over the Faster R-CNN file;
 38. COCODemo on the flagship (the cache's Detectron model_final) at
     min_image_size 800: request, paste and drawing ms, the drawn image,
     the heatmap montage, the webcam loop over 3 frames; the keypoint file
     drawn;
 39. tools/eval_zoo.py's main on configs/caffe2/e2e_mask_rcnn_R_50_FPN_1x_caffe2.yaml
     (its model_final from the cache) with --ann-file/--img-dir: exit 1
     with the published EXPECTED_RESULTS, 0 with a band that holds;
 40. convert("poly") of phase 25's Cityscapes val masks at 1024x2048: ms a
     mask and the round trip's IoU, the native tracing against its plain
     twin on three instances.
Profiling (the model's phase ranges, maskrcnn_tpu_torch/utils/profiling.py):
 44. (in phase 13's first run) the trainer's trace hook at
     MASKRCNN_TPU_PROFILE_AT 2: rank 0's Chrome trace holds the ranges of
     iterations 2-7 and no other, device kernels and every phase range of
     the training step, and the trainer logged its path; the records it
     kept of each hand kernel (not gated: torch.profiler drops some), and
     the run's s/iter on and off the traced iterations;
 45. (after 40) tools/profile_train.py's reading of the flagship's training
     step (batch 8) and of --infer (batch 1), frozen BN calibrated from the
     batch as in phase 7: the phase ranges plus the unattributed time within
     2% of the device busy time, busy within the wall time, every phase
     range holding device time (its own or its dotted parts', the port's
     spans), the shares by phase; phase 11's step time and phase 3's
     latencies beside the step time of the last recorded run before the
     model carried the ranges, and the host cost of one span with nothing
     recording beside a record_function range opened so;
 46. the paths no earlier phase runs: X-101-32x8d Mask R-CNN
     (configs/e2e_mask_rcnn_X_101_32x8d_FPN_1x.yaml) through
     profile_train.build_step at batch 8, remat "auto" on: finite losses,
     every trainable parameter moved, launches a step, ms a step, peak
     memory, its four kernels against their plain versions; the X-152-32x8d
     caffe2 file through build_infer: three timed requests, finite outputs,
     launches, peak memory, NMS and ROIAlign against their plain versions;
     a Keypoint R-CNN request (the keypoint YAML, seeded, heads redrawn as
     in 31) through Predictor with TPU.KEYPOINT_DECODE_ON_DEVICE: launches,
     the device decode on the card against its CPU run within 1e-4 px
     (tests/test_torch_keypoint.py's tolerance for it), its agreement with
     the exact host decode on the same heatmaps and both decodes' times, and
     the request's latency with either decode.
Then each phase's wall seconds, the redesigned kernels' times (NMS, the
matcher, the ROIAlign forward and its three backwards) beside their earlier
designs' (PERF.md), one JSON line of the six kernels (launches by path, the
multi-card path's the two ranks' sum, the tensor-parallel path's the four
ranks' of phase 42, phase 46's paths among them), the card's line, and the
result line. Every profile reading leaves the ranges' own device spans out
and fails where the device reads busier than the wall clock.
"""

import contextlib
import json
import logging
import math
import multiprocessing
import os
import re
import shutil
import tempfile
import subprocess
import sys
import threading
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
REQUEST_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500))
SEED = 0
# bench.py's training batch
TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE = 8, (800, 1344), (800, 1333)
TIMED_STEPS = 5
# phase 44: the trainer's trace hook over phase 13's iterations 2-7
TRACE_AT = 2
# phase 11's training step in the last recorded run before the model carried
# its phase ranges (PERF.md; NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's
UNRANGED_STEP_MS = 73.5
# the phase ranges of the flagship's training step (the JAX package's
# named scopes)
TRAIN_PHASES = ("image_prep", "backbone", "stem", "layer1", "layer2", "layer3", "layer4", "fpn",
                "rpn_head", "rpn_loss", "proposals", "box_targets", "box_head", "box_loss",
                "mask_head", "mask_targets", "optimizer")
# the training entry point's val tree; the evaluation phase's tree: 16
# landscape images, then 16 portrait (the test loader keeps the order, so each
# batch of 8 fills one of the two buckets), with COCO's 80 sparse category ids
VAL_IMAGES = 8
# the multi-card phases: two ranks on the one card; the float32 step's two images
MULTI_WORLD, MULTI_STEPS = 2, 3
F32_HW = (320, 480)
# the model-axis phases 42-43: four ranks on the one card, (data 2, model 2),
# at bench.py's global batch
TP_WORLD, TP_BATCH = 4, 8
EVAL_SIZES = ((480, 640),) * 16 + ((640, 480),) * 16
EVAL_BATCH = 8
COCO_CATEGORY_IDS = [c for c in range(1, 91)
                     if c not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
# the data-layer phases: Cityscapes frames (train, val) at the dataset's
# 2048x1024, with instances of the classes the binary-mask config's 9 hold
# (label ids 24-31; motorcycle and bicycle, 32 and 33, would pass its
# NUM_CLASSES); the VOC test split's images
CITYSCAPES_HW = (1024, 2048)
CITYSCAPES_FRAMES = (16, 8)
CITYSCAPES_IDS = tuple(range(24, 32))
CITYSCAPES_NAMES = dict(zip(CITYSCAPES_IDS, ("person", "rider", "car", "truck", "bus",
                                             "caravan", "trailer", "train")))
VOC_IMAGES = 16
# Keypoint R-CNN's test_net (phase 31; its exact host decode takes ~3 s an
# image): 8 of the 16 val images, one batch; the GN, C4, DCN and FBNet ones
# (32-36): 8; the TTA known answer's second pass (37): its 8 images
KEYPOINT_TEST_IMAGES, FAMILY_TEST_IMAGES, TTA_KNOWN_IMAGES = 8, 8, 8
# the weight of each residual block's last frozen BN and its shortcut's in
# the synthetic R-50.pkl: the body's outputs at a tenth of unit scale, so
# that the published learning rates do not blow up the random heads
R50_RESIDUAL_SCALE = 0.1
# Published H100 SXM peaks at 700 W: HBM bandwidth and float32 arithmetic
# outside the tensor cores (all four kernels run on the CUDA cores); the
# step's MFU takes the dense bf16 peak from maskrcnn_tpu_torch/utils/flops.py.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# arithmetic per IoU test (min/max/sub/add/clamp per side, product, union,
# division, comparison) and per ROIAlign sample and channel (4 products,
# 3 sums, 1 accumulate; the backward's 4 products and 4 adds alike)
NMS_OPS_PER_PAIR = 15
ROI_OPS_PER_SAMPLE = 8
# The times of the redesigned kernels' earlier designs (PERF.md: this script
# on an NVIDIA H100 80GB HBM3 at 700 W), wrapper / kernel alone in ms, by
# (kernel, path, P) for ROIAlign and (kernel, path, lanes) for NMS and the
# matcher, printed beside this run's times.
EARLIER_MS = {
    ("nms", "serving", (5, 1000)): (0.2567, 0.1840), ("nms", "serving", (80, 200)): (0.2592, 0.0577),
    ("nms", "training", (40, 2000)): (0.6366, 0.5703),
    ("matcher", "training", (8, 268569)): (0.1264, 0.1223),
    ("roi_align", "serving", 7): (0.3146, 0.2187), ("roi_align", "serving", 14): (0.2642, 0.0954),
    ("roi_align", "training", 7): (0.8746, 0.8305), ("roi_align", "training", 14): (0.4711, 0.4263),
    ("roi_align_backward", "training", 7): (3.3741, 3.4335),
    ("roi_align_backward", "training", 14): (1.6866, 1.6799),
    ("roi_align_backward_rmw", "training", 7): (5.1030, 4.3008),
    ("roi_align_backward_rmw", "training", 14): (2.8047, 1.5114),
    ("roi_align_backward_chunk", "training", 7): (6.7971, 5.9448),
    ("roi_align_backward_chunk", "training", 14): (4.4408, 1.9995),
}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line():
    """nvidia-smi's name and power limit of the card."""
    from maskrcnn_tpu_torch.utils.profiling import device_line

    return device_line("cuda")


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters=50):
    """fn()'s device time alone and the host's time to issue it: the mean
    milliseconds of `iters` calls issued while the stream waits behind a
    spin of about 0.1 s, so that they run back to back whatever the host's
    pace (CUDA events), and the host's mean wall time per call. None for the
    device time where issuing them outlasted the spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    spin.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / iters
    ahead = not spin.query()  # the spin still running: every call queued
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / iters if ahead else None), issue_ms


class Capture:
    """Records the arguments of a kernel wrapper where the model's modules
    call it (the module attribute `name`), while active: of every call, or
    of the first `limit`, positional in `calls` and keyword in `kwargs`;
    with grads=True also the gradient that reaches each recorded call's
    output in the backward."""

    def __init__(self, modules, name, grads=False, limit=None):
        self.modules, self.name, self.calls, self.limit = modules, name, [], limit
        self.kwargs, self.grads, self.out_grads = [], grads, {}

    def __enter__(self):
        self.saved = [getattr(m, self.name) for m in self.modules]
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, self._recording(fn))
        return self

    def _recording(self, fn):
        def wrapper(*args, **kwargs):
            if self.limit is not None and len(self.calls) >= self.limit:
                return fn(*args, **kwargs)
            self.calls.append(args)
            self.kwargs.append(kwargs)
            out = fn(*args, **kwargs)
            if self.grads and out.requires_grad:
                i = len(self.calls) - 1
                out.register_hook(lambda g: self.out_grads.__setitem__(i, g))
            return out
        return wrapper

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, fn)


def training_counters(poolers, matcher, nms):
    """The launch counters of the kernels a training step may run."""
    return {"matcher": matcher.match_anchors_batched, "nms": nms.batched_nms,
            "roi_align": poolers.multilevel_roi_align,
            "roi_align_backward": poolers.roi_align_backward,
            "roi_align_backward_rmw": poolers.roi_align_backward_rmw,
            "roi_align_backward_chunk": poolers.roi_align_backward_chunk}


class Counter:
    """A launch counter kept as obj's attribute attr, read and reset as
    .launches like the kernels' own."""

    def __init__(self, obj, attr):
        self.obj, self.attr = obj, attr

    @property
    def launches(self):
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.obj, self.attr, value)


def group_norm_counters(layers):
    """The group norm kernels' launch counters: forward and backward calls."""
    return {"group_norm": Counter(layers.group_norm, "launches"),
            "group_norm_backward": Counter(layers.group_norm, "bwd_launches")}


def group_norm_sites(torch, card):
    """The group norm kernels against group_norm_plain at the GN cell's
    shapes (tools/profile_group_norm.py's SHAPES: the step's distinct group
    norms and a C4 res5 ROI batch), in bf16 and float32, by that tool's
    check: the forward within 1e-5 (float32) or one bf16 ulp of max|y|, dx,
    dscale and dbias within 1e-5 / 1e-2 of max|grad| against autograd of
    the plain version, two calls giving the same bits, one launch each way
    a call, y channels_last. Then its times: a forward and a backward site
    each (wrapper and kernel ms, the bound at 3.35 TB/s, the plain
    version's ms; F.group_norm's forward as library_ms, a yardstick)."""
    from maskrcnn_tpu_torch.tools import profile_group_norm as pgn

    fwd, bwd = [], []
    for dname, dtype in pgn.DTYPES.items():
        for name, shape in pgn.SHAPES.items():
            got = pgn.check(shape, dtype)
            check(got["ok"], "group norm {} {} against group_norm_plain: {}".format(
                name, dname, json.dumps(got)))
            t = pgn.times(shape, dtype)
            torch.cuda.empty_cache()
            at = {"site": name, "shape": list(shape), "dtype": got["dtype"],
                  "bitwise_repeatable": got["repeat_equal"], "bound_by": "bytes"}
            fwd.append(dict(at, path=got["path"]["forward"], max_abs_err=got["forward_abs_err"],
                            err=got["forward_err"], tol=got["forward_tol"],
                            ms=t["wrapper_fwd_ms"], kernel_ms=t["kernel_fwd_ms"],
                            plain_ms=t["plain_fwd_ms"], bound_ms=t["bound_fwd_ms"],
                            library_ms=t["library_fwd_ms"]))
            bwd.append(dict(at, path=got["path"]["backward"],
                            max_abs_err=max(got["grad_abs_err"].values()),
                            err=got["grad_err"], tol=got["grad_tol"],
                            ms=t["wrapper_bwd_ms"], kernel_ms=t["kernel_bwd_ms"],
                            plain_ms=t["plain_bwd_ms"], bound_ms=t["bound_bwd_ms"]))
            for kind, site in (("group_norm", fwd[-1]), ("group_norm_backward", bwd[-1])):
                print("gn recipe kernel site {} [{}]: {}".format(kind, card, json.dumps(site)),
                      flush=True)
    return {"group_norm": fwd, "group_norm_backward": bwd}


@contextlib.contextmanager
def environ(**values):
    """Environment variables set for the duration of a block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_ms(torch, fn, iters=20):
    """{device kernel or memset name: ms per launch}, from torch.profiler's
    records of `iters` calls of fn (empty where the profiler sees no device
    time); where a name has not one record a call, "records" gives how many
    it has (the mean is over those)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out, records = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and self_device_us(e) > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].strip()[:60]
            out[name] = self_device_us(e) / 1e3 / e.count
            if e.count != iters:
                records[name] = e.count
    if records:
        out["records"] = dict(records, calls=iters)
    return out


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nms_site(torch, nms, boxes, scores, valid, thresh, plain_iters):
    got = nms.batched_nms(boxes, scores, valid, thresh)
    want = nms.batched_nms_plain(boxes, scores, valid, thresh)
    check(torch.equal(got, want), "NMS kernel disagrees with its plain version at {}"
          .format(tuple(boxes.shape)))
    # IoU tests the greedy scan needs on these inputs: every kept box
    # against each later valid box
    order, _, svalid = nms._sort_lanes(boxes, scores, valid)
    skeep = torch.gather(want, 1, order)
    later = svalid.flip(1).cumsum(1).flip(1) - svalid.long()
    pairs = int((skeep.long() * later).sum())
    g, n = scores.shape
    prepared = nms.prepare(boxes, scores, valid)
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    nbytes = g * n * (16 + 4 + 1) + g * n  # boxes, scores, valid in; keep out
    b_ms, b_by = bound(nbytes, NMS_OPS_PER_PAIR * pairs)
    queued, issue = queued_ms(torch, lambda: nms.launch(*prepared, keep, thresh))
    return {
        "shape": [g, n], "iou_threshold": thresh, "kept": int(want.sum()),
        "max_abs_err": float((got != want).sum()),
        "ms": cuda_ms(torch, lambda: nms.batched_nms(boxes, scores, valid, thresh), 50),
        "kernel_ms": cuda_ms(torch, lambda: nms.launch(*prepared, keep, thresh), 50),
        "launch_ms": launch_ms(torch, lambda: nms.launch(*prepared, keep, thresh)),
        "kernel_queued_ms": queued, "issue_ms": issue,
        "plain_ms": cuda_ms(torch, lambda: nms.batched_nms_plain(boxes, scores, valid, thresh),
                            plain_iters, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "iou_tests": pairs,
    }


def roi_levels(torch, poolers, shapes, boxes, pcfg):
    """Each ROI's level [R] int32, as the wrapper assigns it."""
    if len(shapes) > 1:
        return poolers.assign_levels(boxes, pcfg).contiguous()
    return torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)


def roi_work(torch, poolers, shapes, boxes, bidx, pcfg):
    """(distinct feature cells the kernels' samples read, samples they take)
    on a call's ROIs. A sample reads the bilinear cells of its row and of
    its column unless either lies outside, so an ROI reads the cells of its
    valid rows times those of its valid columns; the fixed grid takes
    (P * S)^2 samples an ROI, the adaptive grid each bin's n_y * n_x (the
    samples of weight 0 are skipped). shapes: [(B, Hl, Wl, ...)]."""
    lvl = roi_levels(torch, poolers, shapes, boxes, pcfg).long()
    rows, cols = poolers.sample_axes(shapes, boxes, lvl, pcfg)
    for axis in (rows, cols):
        axis["taken"] = axis["w"] > 0 if pcfg.adaptive else torch.ones_like(axis["valid"])
    samples = int((rows["taken"].sum(1) * cols["taken"].sum(1)).sum())
    cells = 0
    for level, shape in enumerate(shapes):
        on = lvl == level

        def touched(axis, size):
            read = (axis["valid"] & axis["taken"])[on].float()
            m = torch.zeros((read.shape[0], size), device=boxes.device)
            m.scatter_add_(1, axis["lo"][on], read).scatter_add_(1, axis["hi"][on], read)
            return (m > 0).float()

        rm, cm = touched(rows, shape[1]), touched(cols, shape[2])
        images = bidx.long()[on]
        for b in range(shape[0]):
            mine = images == b
            cells += int(((rm[mine].T @ cm[mine]) > 0).sum())
    return cells, samples


def roi_site(torch, poolers, feats, boxes, bidx, pcfg, rois_per_image=None, plain_iters=10):
    """The forward kernel on a main path's call against its plain version,
    timed beside its bound. The fixed grid against
    multilevel_roi_align_plain: float32 within 1e-5, the features' dtype
    within 1e-2 of max|x|. The adaptive grid against the float32 gather
    path (adaptive_roi_align without ROI blocks): float32 within 1e-5 of the
    pooled output's max, bfloat16 within 1e-2 of max|x| (one rounding); its
    plain time is adaptive_roi_align as CPU tensors run it, with the call's
    rois_per_image. Two calls give the same bits."""
    roi = poolers.multilevel_roi_align
    f32 = [f.float() for f in feats]
    if pcfg.adaptive:
        want32 = poolers.adaptive_roi_align(f32, boxes, bidx, pcfg)
        lim32 = 1e-5 * want32.abs().max().item()

        def plain():
            return poolers.adaptive_roi_align(feats, boxes, bidx, pcfg, rois_per_image)
    else:
        want32 = poolers.multilevel_roi_align_plain(f32, boxes, bidx, pcfg)
        lim32 = 1e-5

        def plain():
            return poolers.multilevel_roi_align_plain(feats, boxes, bidx, pcfg)
    err32 = (roi(f32, boxes, bidx, pcfg) - want32).abs().max().item()
    check(err32 <= lim32, "ROIAlign kernel (float32) off by {} > {} at P={}".format(
        err32, lim32, pcfg.output_size))
    del f32
    got = roi(feats, boxes, bidx, pcfg)
    want = want32 if pcfg.adaptive else plain()
    del want32
    err = (got.float() - want.float()).abs().max().item()
    limit = 1e-2 * max(f.abs().max().item() for f in feats)
    check(err <= limit, "ROIAlign kernel ({}) off by {} > {} at P={}".format(
        feats[0].dtype, err, limit, pcfg.output_size))
    check(torch.equal(roi(feats, boxes, bidx, pcfg), got),
          "two calls of the ROIAlign kernel differ at P={}".format(pcfg.output_size))
    del want
    # bytes: each feature cell a sample touches read once, boxes and image
    # indices read once, the pooled output written once
    shapes = [tuple(f.shape) for f in feats]
    cells, samples = roi_work(torch, poolers, shapes, boxes, bidx, pcfg)
    r, p, c = boxes.shape[0], pcfg.output_size, feats[0].shape[-1]
    item = feats[0].element_size()
    b32, i32 = boxes.contiguous(), bidx.to(torch.int32).contiguous()
    lvl = roi_levels(torch, poolers, shapes, b32, pcfg)
    out = torch.empty_like(got)
    nbytes = r * p * p * c * item + cells * c * item + r * (16 + 4)
    b_ms, b_by = bound(nbytes, c * (ROI_OPS_PER_SAMPLE * samples + r * p * p))
    site = {"rois": r, "P": p, "dtype": str(feats[0].dtype).replace("torch.", "")}
    if pcfg.adaptive:
        site.update(grid="adaptive", samples_an_axis_max=poolers.adaptive_cap(pcfg, shapes),
                    samples_a_bin_mean=samples / (r * p * p), map=list(shapes[0]),
                    rois_per_image=rois_per_image, bitwise_repeatable=True)
    site.update({
        "max_abs_err": err, "max_abs_err_float32": err32, "cells_read": cells,
        "ms": cuda_ms(torch, lambda: roi(feats, boxes, bidx, pcfg), 50),
        "kernel_ms": cuda_ms(torch, lambda: poolers.launch(feats, b32, i32, lvl, pcfg, out), 50),
        "plain_ms": cuda_ms(torch, plain, plain_iters, warmup=1 if pcfg.adaptive else 2),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    return site


def matcher_site(torch, matcher, anchors, gt_boxes, gt_valid, high, low, timeline=False):
    """The matcher against its plain version, timed; with timeline=True also
    the phases of one launch from the kernel's own clock (an instrumented
    copy: tools/profile_nms_matcher.py --timeline), microseconds from the
    first block's start to the last block's end of each phase."""
    from maskrcnn_tpu_torch.ops import native
    from maskrcnn_tpu_torch.tools.profile_nms_matcher import matcher_timeline

    got = matcher.match_anchors_batched(anchors, gt_boxes, gt_valid, high, low)
    want = matcher.match_anchors_plain(anchors, gt_boxes, gt_valid, high, low)
    check(torch.equal(got, want), "matcher kernel disagrees with its plain version")
    b, g = gt_valid.shape
    n = anchors.shape[0]
    best = torch.empty((b, g), dtype=torch.int32, device=anchors.device)
    out = torch.empty((b, n), dtype=torch.int32, device=anchors.device)
    inputs = (anchors.contiguous(), gt_boxes.contiguous(), gt_valid.contiguous())
    # bytes: anchors, gt and validity read once, the matches written once;
    # operations: one IoU of each anchor with each valid gt its box
    # overlaps (a pair that does not overlap has IoU 0 without one: the
    # kernel skips a gt outside a warp's anchors whole)
    valid_gt = int(gt_valid.sum())
    overlapping = 0
    for i in range(b):
        gi = gt_boxes[i][gt_valid[i]]
        lo = torch.maximum(anchors[:, None, :2], gi[None, :, :2])
        hi = torch.minimum(anchors[:, None, 2:], gi[None, :, 2:])
        overlapping += int(((hi - lo + 1) > 0).all(-1).sum())
    b_ms, b_by = bound(16 * n + 17 * b * g + 4 * b * n, NMS_OPS_PER_PAIR * overlapping)
    queued, issue = queued_ms(torch, lambda: matcher.launch(*inputs, high, low, best, out))
    return {
        "anchors": n, "images": b, "gt_per_image": g, "valid_gt": valid_gt,
        "overlapping_pairs": overlapping, "max_abs_err": float((got != want).sum()),
        "ms": cuda_ms(torch, lambda: matcher.match_anchors_batched(
            anchors, gt_boxes, gt_valid, high, low), 50),
        "kernel_ms": cuda_ms(torch, lambda: matcher.launch(*inputs, high, low, best, out), 50),
        "launch_ms": launch_ms(torch, lambda: matcher.launch(*inputs, high, low, best, out)),
        "kernel_queued_ms": queued, "issue_ms": issue,
        "timeline_us": matcher_timeline(native, matcher, *inputs, high, low) if timeline else None,
        "plain_ms": cuda_ms(torch, lambda: matcher.match_anchors_plain(
            anchors, gt_boxes, gt_valid, high, low), 5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def roi_backward_site(torch, poolers, feats, boxes, bidx, pcfg, dout, kind="roi",
                      rois_per_image=None):
    """The backward kernel `kind` ("roi", "rmw" or "chunk") on the gradient
    the step's backward gave the pooled output, against autograd through the
    plain float32 forward (the adaptive grid's: the gather path); for the
    window backwards also the shape of their layout on these ROIs. The
    adaptive grid's plain time is the forward and backward of
    adaptive_roi_align in dOut's dtype, as CPU tensors run it with the
    call's rois_per_image."""
    shapes = [tuple(f.shape) for f in feats]
    b32, i32 = boxes.detach().contiguous(), bidx.to(torch.int32).contiguous()
    lvl = roi_levels(torch, poolers, shapes, b32, pcfg)
    wrapper = poolers.BACKWARD_KERNELS[kind]
    got = wrapper(dout, shapes, b32, i32, lvl, pcfg)
    got32 = wrapper(dout.float(), shapes, b32, i32, lvl, pcfg)
    # a fixed order of sums: a second call gives the same bits
    again = wrapper(dout, shapes, b32, i32, lvl, pcfg)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          "two calls of the {} backward differ at P={}".format(kind, pcfg.output_size))
    del again
    leaves = [torch.zeros(sh, device=dout.device, requires_grad=True) for sh in shapes]
    if pcfg.adaptive:
        # the gather path's chunks run under checkpoint: a graph per call
        want = torch.autograd.grad(poolers.adaptive_roi_align(leaves, b32, bidx, pcfg), leaves,
                                   dout.float())
        leaves = [torch.zeros(sh, dtype=dout.dtype, device=dout.device, requires_grad=True)
                  for sh in shapes]

        def plain():
            return torch.autograd.grad(poolers.adaptive_roi_align(
                leaves, b32, bidx, pcfg, rois_per_image), leaves, dout)
    else:
        plain_out = poolers.multilevel_roi_align_plain(leaves, b32, bidx, pcfg)
        want = torch.autograd.grad(plain_out, leaves, dout.float(), retain_graph=True)

        def plain():
            return torch.autograd.grad(plain_out, leaves, dout.float(), retain_graph=True)
    scale = max(w.abs().max().item() for w in want)
    err32 = max((g - w).abs().max().item() for g, w in zip(got32, want))
    err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
    check(scale > 0, "ROIAlign backward: zero gradient at P={}".format(pcfg.output_size))
    check(err32 <= 1e-5 * scale, "ROIAlign {} backward kernel (float32) off by {} > 1e-5 * {}"
          .format(kind, err32, scale))
    check(err <= 1e-2 * scale, "ROIAlign {} backward kernel ({}) off by {} > 1e-2 * {}".format(
        kind, dout.dtype, err, scale))
    del want
    total = sum(math.prod(sh) for sh in shapes)
    out = torch.empty((total,), dtype=dout.dtype, device=dout.device)
    dc = dout.contiguous()
    r, p, c = dout.shape[0], pcfg.output_size, dout.shape[-1]
    _, samples = roi_work(torch, poolers, shapes, b32, bidx, pcfg)
    item = dout.element_size()
    # bytes: dOut, boxes and image indices read once, the dense gradient of
    # every pooled level written once in the compute dtype
    b_ms, b_by = bound(dout.numel() * item + r * 20 + total * item,
                       c * (ROI_OPS_PER_SAMPLE * samples + r * p * p))
    site = {"kind": kind, "rois": r, "P": p, "dtype": str(dout.dtype).replace("torch.", ""),
            "bitwise_repeatable": True}
    if pcfg.adaptive:
        site.update(grid="adaptive", samples_a_bin_mean=samples / (r * p * p),
                    map=list(shapes[0]), rois_per_image=rois_per_image)
    if kind == "roi":
        inputs = poolers.roi_tile_inputs(shapes, i32, lvl)
        # how the ROIs load the tiles: the crowded tiles set the kernel's time
        per_tile = [len(v) for v in poolers.tile_lists(shapes, b32.cpu(), i32.cpu(), lvl.cpu(),
                                                         pcfg).values()]
        site.update(rois_per_level=torch.bincount(lvl.long(), minlength=len(shapes)).tolist(),
                    tiles=sum(-(-sh[1] // poolers.TILE) * -(-sh[2] // poolers.TILE) * sh[0]
                              for sh in shapes),
                    tiles_met=len(per_tile), tile_roi_pairs=sum(per_tile),
                    rois_per_tile_max=max(per_tile, default=0),
                    tiles_met_by_100_rois_or_more=sum(n >= 100 for n in per_tile))
    else:
        inputs = poolers.window_kernel_inputs(kind, shapes, b32, i32, lvl, pcfg)
        # the window index: windows holding an ROI that fits, and their rows
        rows = (inputs["end"] - inputs["first"]).clamp(min=0)
        windows = int((rows > 0).sum())
        site.update(windows=windows, rows_per_window_mean=int(rows.sum()) / max(windows, 1),
                    rows_per_window_max=int(rows.max()),
                    oversize_rois=int(inputs["oversize"].sum()))
        if kind == "chunk":
            pure = inputs["chunks"]["pure"]
            site.update(chunks=int(pure.numel()), pure_chunk_share=float(pure.float().mean()))
    site.update({
        "max_abs_err": err, "max_abs_err_float32": err32, "max_abs_grad": scale,
        "ms": cuda_ms(torch, lambda: wrapper(dout, shapes, b32, i32, lvl, pcfg), 20),
        "kernel_ms": cuda_ms(torch, lambda: poolers.launch_backward(
            shapes, b32, pcfg, dc, out, kind, inputs), 20),
        "plain_ms": cuda_ms(torch, plain, 1 if pcfg.adaptive else 5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    return site


def adaptive_pooler_sites(torch, poolers, cap, path):
    """The adaptive grid's pooler calls of a step that `cap` recorded (a
    Capture of multilevel_roi_align with grads=True; box, then mask), each
    held to the gather path forward (roi_site) and, where the step's
    backward reached its output, backward on that gradient
    (roi_backward_site, "roi"): (forward sites, backward sites). The
    recorded calls are let go."""
    fwd, bwd = [], []
    for i, (call, kwargs) in enumerate(zip(cap.calls, cap.kwargs)):
        feats, boxes, bidx, pcfg = [f.detach() for f in call[0]], *call[1:]
        check(pcfg.adaptive, "{}: pooler call {} on the fixed grid".format(path, i))
        k = kwargs.get("rois_per_image")
        with torch.no_grad():
            fwd.append(roi_site(torch, poolers, feats, boxes, bidx, pcfg, k, plain_iters=1))
        if i in cap.out_grads:
            bwd.append(roi_backward_site(torch, poolers, feats, boxes, bidx, pcfg,
                                         cap.out_grads[i], "roi", k))
    cap.calls.clear()
    cap.kwargs.clear()
    cap.out_grads.clear()
    torch.cuda.empty_cache()
    return fwd, bwd


def kernel_entry(name, source, replaces, launches, sites):
    """One kernel's line entry: times are means per launch over the main
    paths' call sites; launches is {path: count in that path's run}, and
    "launches" their sum; sites has each site."""
    mean = lambda k: sum(s[k] for s in sites) / len(sites)  # noqa: E731
    by = [s["bound_by"] for s in sites]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        "ms": mean("ms"), "kernel_ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(set(by), key=by.count), "library_ms": None, "sites": sites,
    }


def calibrate_frozen_bn(torch, model, images, residual_scale=1.0):
    """Set every frozen BN of the backbone body from one batch, layer by
    layer: running mean and variance (+1e-5) of the conv output it follows,
    weight 1, bias 0. Random weights with identity BN let activations grow
    by orders of magnitude through the 16 residual blocks; a trained
    model's BN keeps them near unit scale, and so does this.

    residual_scale: the weight of each block's last BN and of its
    shortcut's BN (1 above). The other BNs normalise whatever reaches them,
    so every stage's output, and with it everything the FPN and the heads
    compute at their init, scales by exactly this factor."""
    import torch.nn.functional as F

    from maskrcnn_tpu_torch.models import resnet

    folded = resnet.conv_frozen_bn
    last = {id(m.bn3) for m in model.modules() if isinstance(m, resnet.Bottleneck)}
    last |= {id(m.downsample.bn) for m in model.modules()
             if isinstance(m, resnet.Bottleneck) and m.downsample is not None}

    def calibrating(x, conv, bn):
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation,
                     conv.groups)
        bn.weight.fill_(residual_scale if id(bn) in last else 1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3)) + 1e-5)
        return folded(x, conv, bn)

    resnet.conv_frozen_bn = calibrating
    try:
        with torch.no_grad():
            x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            model.backbone.body(x)
    finally:
        resnet.conv_frozen_bn = folded


def detectron_blobs(np, state, imagenet=False, seed=0):
    """The port's state_dict (numpy arrays by name) under Detectron's Caffe2
    blob names, written from Detectron's own naming: an ImageNet backbone file
    (imagenet=True: the ResNet body, a seeded fc1000 and a _momentum blob of
    each) or a whole Faster / Mask / Keypoint R-CNN model_final (body, FPN
    and RPN, or the C4 body and RPN with res5 in the box head; box head and
    the mask or keypoint head it has). Frozen BN becomes Detectron's affine
    pair (_bn_s, _bn_b), which holds no running statistics, group norm its
    _gn_s / _gn_b pair; fc6's input columns go back from the port's (P, P, C)
    flatten to Caffe2's (C, P, P)."""
    blobs = {}

    def norm(prefix, name):
        if prefix + ".scale" in state:  # group norm
            blobs[name + "_gn_s"], blobs[name + "_gn_b"] = (state[prefix + ".scale"],
                                                            state[prefix + ".bias"])
            return
        w, b, m, v = (state[prefix + k] for k in (".weight", ".bias", ".running_mean",
                                                  ".running_var"))
        s = w / np.sqrt(v)
        blobs[name + "_bn_s"], blobs[name + "_bn_b"] = s, b - m * s

    def layer(prefix, name):
        blobs[name + "_w"] = state[prefix + ".weight"]
        if prefix + ".bias" in state:
            blobs[name + "_b"] = state[prefix + ".bias"]

    body = "backbone.body."
    layer(body + "stem.conv1", "conv1")
    norm(body + "stem.bn1", "conv1" if body + "stem.bn1.scale" in state else "res_conv1")
    blocks = {}  # stage -> (prefix of its blocks, count): the C4 res5 lives in the box head
    for k in state:
        m = re.match(r"(backbone\.body\.|roi_heads\.box\.feature_extractor\.head\.)"
                     r"layer(\d)\.(\d+)\.", k)
        if m:
            n = blocks.get(int(m[2]), (None, 0))[1]
            blocks[int(m[2])] = (m[1], max(n, int(m[3]) + 1))
    for stage, (base, n) in sorted(blocks.items()):
        for i in range(n):
            p, r = "{}layer{}.{}.".format(base, stage, i), "res{}_{}_".format(stage + 1, i)
            for k, branch in enumerate(("branch2a", "branch2b", "branch2c"), 1):
                layer(p + "conv{}".format(k), r + branch)
                norm(p + "bn{}".format(k), r + branch)
            if p + "downsample.conv.weight" in state:
                layer(p + "downsample.conv", r + "branch1")
                norm(p + "downsample.bn", r + "branch1")
    if imagenet:
        rs = np.random.RandomState(seed)
        c = blobs["res5_{}_branch2c_w".format(blocks[4][1] - 1)].shape[0]
        blobs["fc1000_w"] = rs.normal(0, 0.01, (1000, c)).astype(np.float32)
        blobs["fc1000_b"] = np.zeros(1000, np.float32)
        blobs.update({k + "_momentum": np.zeros_like(v) for k, v in list(blobs.items())})
        return blobs
    fpn = "backbone.fpn.layer.0.conv.weight" in state
    if fpn:
        for i in range(4):
            stage = "res{}_{}_sum".format(i + 2, blocks[i + 1][1] - 1)
            layer("backbone.fpn.inner.{}.conv".format(i),
                  "fpn_inner_" + stage + ("_lateral" if i < 3 else ""))
            layer("backbone.fpn.layer.{}.conv".format(i), "fpn_" + stage)
    rpn = "_fpn2" if fpn else ""
    heads = {"rpn.conv": "conv_rpn" + rpn, "rpn.cls_logits": "rpn_cls_logits" + rpn,
             "rpn.bbox_pred": "rpn_bbox_pred" + rpn,
             "roi_heads.box.feature_extractor.fc6": "fc6",
             "roi_heads.box.feature_extractor.fc7": "fc7",
             "roi_heads.box.predictor.cls_score": "cls_score",
             "roi_heads.box.predictor.bbox_pred": "bbox_pred",
             "roi_heads.mask.predictor.conv5_mask": "conv5_mask",
             "roi_heads.mask.predictor.mask_fcn_logits": "mask_fcn_logits"}
    heads.update({"roi_heads.mask.feature_extractor.convs.{}.conv".format(k):
                  "_[mask]_fcn{}".format(k + 1) for k in range(4)})
    heads.update({"roi_heads.keypoint.feature_extractor.conv_fcn{}".format(k):
                  "conv_fcn{}".format(k) for k in range(1, 9)})
    heads["roi_heads.keypoint.predictor.kps_score_lowres"] = "kps_score_lowres"
    for prefix, name in heads.items():
        if prefix + ".weight" in state:
            layer(prefix, name)
    if "fc6_w" in blobs:
        w = blobs["fc6_w"]
        c = state["backbone.fpn.layer.0.conv.weight"].shape[0]
        p = int(round((w.shape[1] // c) ** 0.5))
        blobs["fc6_w"] = np.ascontiguousarray(
            w.reshape(w.shape[0], p, p, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1))
    return blobs


def write_pkl(path, blobs, wrap):
    """A Detectron weight file: the blobs themselves (ImageNet) or under
    "blobs" (a detector's model_final), pickled as Python 2 pickled them."""
    import pickle

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs, "cfg": ""} if wrap else blobs, f, protocol=2)


def match_detections(a, b, score_tol=1e-4, box_tol=1e-2, mask_tol=1e-3):
    """Fraction of a's detections (BoxLists) with a partner in b: same
    label, score within score_tol, box within box_tol px, mask
    probabilities (of mask models) within mask_tol."""
    matched = 0
    la, lb = a.get_field("labels"), b.get_field("labels")
    sa, sb = a.get_field("scores"), b.get_field("scores")
    masks = a.has_field("mask")
    ma, mb = (a.get_field("mask"), b.get_field("mask")) if masks else (None, None)
    for i in range(len(a)):
        for j in range(len(b)):
            if (la[i] == lb[j] and abs(sa[i] - sb[j]) <= score_tol
                    and abs(a.bbox[i] - b.bbox[j]).max() <= box_tol
                    and (not masks or abs(ma[i] - mb[j]).max() <= mask_tol)):
                matched += 1
                break
    return matched / max(len(a), 1)


def run(torch):
    sys.path.insert(0, REPO)
    import numpy as np

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.models import detector, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.ops import matcher, native, nms
    from maskrcnn_tpu_torch.predictor import Predictor

    # 1. card and build
    t_start = time.perf_counter()
    card = card_line()
    print("card:", card, flush=True)
    t0 = time.perf_counter()
    logs = native.build(native.KERNELS + native.HOST_LIBS)
    print("built {} in {:.1f} s ({})".format(
        ", ".join(native.KERNELS + native.HOST_LIBS), time.perf_counter() - t0,
        "compiled: " + ", ".join(logs) if logs else "already built"), flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  {}: {}".format(name, line.strip()))
    for name in native.KERNELS:
        native.load(name)

    # 2. model
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    print("config: Mask R-CNN R-50-FPN, full width, bfloat16 compute; ROI_HEADS.SCORE_THRESH "
          "lowered to 0.0 (random weights, seed {})".format(SEED), flush=True)
    rs = np.random.RandomState(SEED)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUEST_SIZES]
    t0 = time.perf_counter()
    pred = Predictor(cfg, device="cuda", seed=SEED,
                     min_image_size=cfg.INPUT.MIN_SIZE_TEST)
    calibrate_frozen_bn(torch, pred.model, pred.preprocess(warm)[0])
    torch.cuda.synchronize()
    print("model built in {:.1f} s; frozen-BN statistics set from the warm-up image"
          .format(time.perf_counter() - t0), flush=True)

    # 3. requests
    t0 = time.perf_counter()
    pred.compute_prediction(warm)
    print("warm-up request: {:.1f} ms".format((time.perf_counter() - t0) * 1e3), flush=True)

    results, latencies = [], []

    def serve(img):
        t0 = time.perf_counter()
        results.append(pred.compute_prediction(img))  # ends in copies to the host
        latencies.append((time.perf_counter() - t0) * 1e3)
        print("request {} {}x{}: {:.2f} ms, {} detections [{}]".format(
            len(results) - 1, img.shape[0], img.shape[1], latencies[-1],
            len(results[-1]["scores"]), card), flush=True)

    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    with Capture([rpn, box_head], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align") as roi_cap:
        serve(images[0])
    for img in images[1:]:
        serve(img)
    serving = {k: fn.launches for k, fn in counters.items()}
    n_nms, n_roi = serving["nms"], serving["roi_align"]

    # 4. launch counts of the main path
    print("launches in {} requests: {}".format(len(images), json.dumps(serving)))
    check(all(serving[k] == 0 for k in serving if k not in ("nms", "roi_align")),
          "serving launched training kernels")
    check(n_nms == 2 * len(images), "NMS kernel launched {} times, expected {}"
          .format(n_nms, 2 * len(images)))
    check(n_roi == 2 * len(images), "ROIAlign kernel launched {} times, expected {}"
          .format(n_roi, 2 * len(images)))

    # the same requests again, every shape now seen once
    seen = []
    for img in images:
        t0 = time.perf_counter()
        pred.compute_prediction(img)
        seen.append((time.perf_counter() - t0) * 1e3)
    print("second pass, shapes seen: " + ", ".join("{:.2f} ms".format(t) for t in seen))

    # 5. kernels against their plain versions on the main path's inputs
    check(len(nms_cap.calls) == 2 and len(roi_cap.calls) == 2,
          "captured {} NMS and {} ROIAlign calls in one request"
          .format(len(nms_cap.calls), len(roi_cap.calls)))
    with torch.inference_mode():
        nms_sites = [nms_site(torch, nms, *call, plain_iters=3) for call in nms_cap.calls]
        roi_sites = [roi_site(torch, poolers, *call) for call in roi_cap.calls]
    (g0, n0), (g1, n1) = nms_sites[0]["shape"], nms_sites[1]["shape"]
    check((g0, n0) == (5, 1000) and (g1, n1) == (80, 200),
          "NMS lanes {} and {}, expected [5, 1000] and [80, 200]".format((g0, n0), (g1, n1)))
    check((roi_sites[0]["rois"], roi_sites[0]["P"]) == (1000, 7)
          and (roi_sites[1]["rois"], roi_sites[1]["P"]) == (100, 14),
          "ROIAlign sites {}".format([(s["rois"], s["P"]) for s in roi_sites]))
    for s in nms_sites + roi_sites:
        print("kernel site:", json.dumps(s), flush=True)

    # 6. outputs
    for k, (img, out) in enumerate(zip(images, results)):
        n = len(out["scores"])
        h, w = img.shape[:2]
        check(0 < n <= cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG, "request {}: {} detections".format(k, n))
        check(out["boxes"].shape == (n, 4) and np.isfinite(out["boxes"]).all(), "bad boxes")
        check(np.isfinite(out["scores"]).all() and (out["scores"] >= 0).all()
              and (out["scores"] <= 1).all(), "bad scores")
        check(((out["labels"] >= 1) & (out["labels"] <= 80)).all(), "bad labels")
        check(out["masks"].shape == (n, h, w) and out["masks"].dtype == np.uint8, "bad masks")
        check((out["boxes"][:, [0, 2]] <= w * 1.001).all() and (out["boxes"][:, [1, 3]] <= h * 1.001).all(),
              "boxes outside the image")
    ref = reference_check(torch, np, detector, cfg, pred.model.state_dict())
    print("float32 card vs CPU on a 256x320 image: " + json.dumps(ref), flush=True)
    check(ref["agree"] >= 0.9, "card and CPU disagree on {:.1%} of detections"
          .format(1 - ref["agree"]))

    print("latency ms per request: " + json.dumps(latencies)
          + "; second pass: " + json.dumps(seen), flush=True)
    del pred, results
    torch.cuda.empty_cache()

    phase_s = {"serving": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    tr = train_phase(torch, np, card)
    torch.cuda.empty_cache()
    phase_s["training"] = time.perf_counter() - t0
    keep = {name: tempfile.mkdtemp(prefix="chip_smoke_{}_".format(name))
            for name in ("entry", "eval")}
    try:
        t0 = time.perf_counter()
        entry = entry_point_phase(torch, np, card, tr["throughput"], keep["entry"])
        torch.cuda.empty_cache()
        phase_s["entry_point"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = evaluation_phase(torch, np, card, keep["eval"])
        torch.cuda.empty_cache()
        phase_s["evaluation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mc = multi_card_phase(torch, np, card, keep)
        phase_s["multi_card"] = time.perf_counter() - t0
        phase_s.update(mc["phase_s"])
    finally:
        for d in keep.values():
            shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    dl = data_layer_phase(torch, np, card)
    torch.cuda.empty_cache()
    phase_s["data_layer"] = time.perf_counter() - t0
    phase_s.update({"data_layer_" + k: v for k, v in dl["phase_s"].items()})
    t0 = time.perf_counter()
    pp = profiling_phase(torch, np, card, tr["throughput"]["step_ms"], seen)
    phase_s["profiling"] = time.perf_counter() - t0
    phase_s.update({"profiling_" + k: v for k, v in pp["phase_s"].items()})
    print("phase wall seconds: " + json.dumps(phase_s), flush=True)

    def by_path(key):
        paths = {"serving": serving[key], "training": tr["launches"][key],
                 "entry_point": entry["launches"][key], "evaluation": ev["launches"][key],
                 "multi_card": mc["launches"][key],
                 "tensor_parallel": mc["tensor_parallel"]["launches"][key]}
        paths.update({path: n[key] for path, n in dl["launches"].items()})
        paths.update({path: n[key] for path, n in pp["launches"].items()})
        return paths

    roi_cu = "maskrcnn_tpu_torch/csrc/roi_align.cu"
    tpu = "maskrcnn_tpu/ops/pallas/"
    tp = mc["tensor_parallel"]
    cs = {k: [s for path in list(dl["sites"].values()) + list(pp["sites"].values())
              for s in path.get(k, [])]
          for k in ("nms", "roi_align", "roi_align_backward", "matcher", "group_norm",
                    "group_norm_backward")}
    gn_cu = "maskrcnn_tpu_torch/csrc/group_norm.cu"  # replaces no TPU kernel

    def gn_path(key):  # the data-layer phases alone count the group norms
        return {path: n[key] for path, n in dl["launches"].items()}
    kernels = [
        kernel_entry("nms", "maskrcnn_tpu_torch/csrc/nms.cu", tpu + "nms_kernel.py:161",
                     by_path("nms"), nms_sites + tr["nms_sites"] + ev["nms_sites"]
                     + mc["nms_sites"] + tp["nms_sites"] + cs["nms"]),
        kernel_entry("roi_align", roi_cu, tpu + "roi_align_kernel.py:434", by_path("roi_align"),
                     roi_sites + tr["roi_sites"] + ev["roi_sites"] + mc["roi_sites"]
                     + tp["roi_sites"] + cs["roi_align"]),
        kernel_entry("roi_align_backward", roi_cu, tpu + "roi_align_kernel.py:1020",
                     by_path("roi_align_backward"), tr["bwd_sites_roi"] + mc["bwd_sites_roi"]
                     + tp["bwd_sites_roi"] + cs["roi_align_backward"]),
        kernel_entry("roi_align_backward_rmw", roi_cu, tpu + "roi_align_kernel.py:646",
                     by_path("roi_align_backward_rmw"), tr["bwd_sites_rmw"]),
        kernel_entry("roi_align_backward_chunk", roi_cu, tpu + "roi_align_kernel.py:850",
                     by_path("roi_align_backward_chunk"), tr["bwd_sites_chunk"]),
        kernel_entry("matcher", "maskrcnn_tpu_torch/csrc/matcher.cu",
                     tpu + "matcher_kernel.py:183", by_path("matcher"),
                     tr["matcher_sites"] + mc["matcher_sites"] + tp["matcher_sites"]
                     + cs["matcher"]),
        kernel_entry("group_norm", gn_cu, None, gn_path("group_norm"), cs["group_norm"]),
        kernel_entry("group_norm_backward", gn_cu, None, gn_path("group_norm_backward"),
                     cs["group_norm_backward"]),
    ]
    kernels[-2]["library_ms"] = (sum(s["library_ms"] for s in cs["group_norm"])
                                 / len(cs["group_norm"]))

    def shape(name, s):
        if name == "nms":
            return tuple(s["shape"])
        return (s["images"], s["anchors"]) if name == "matcher" else s["P"]

    redesigned = [
        {"kernel": name, "path": path, "shape": shape(name, s), "ms": s["ms"],
         "kernel_ms": s["kernel_ms"], "launch_ms": s.get("launch_ms"), "bound_ms": s["bound_ms"],
         "earlier_ms": EARLIER_MS[(name, path, shape(name, s))][0],
         "earlier_kernel_ms": EARLIER_MS[(name, path, shape(name, s))][1]}
        for name, path, sites in (("nms", "serving", nms_sites),
                                  ("nms", "training", tr["nms_sites"]),
                                  ("matcher", "training", tr["matcher_sites"]),
                                  ("roi_align", "serving", roi_sites),
                                  ("roi_align", "training", tr["roi_sites"]),
                                  ("roi_align_backward", "training", tr["bwd_sites_roi"]),
                                  ("roi_align_backward_rmw", "training", tr["bwd_sites_rmw"]),
                                  ("roi_align_backward_chunk", "training",
                                   tr["bwd_sites_chunk"]))
        for s in sites]
    print("redesigned kernels, this run against the earlier designs' times in PERF.md "
          "[{}]: {}".format(card, json.dumps(redesigned)), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def train_phase(torch, np, card):
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.tools.profile_train import train_batch
    from maskrcnn_tpu_torch.utils import flops as flop_count
    from maskrcnn_tpu_torch.utils import profiling

    # 7. model, batch, optimizer
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    t0 = time.perf_counter()
    model = build_detection_model(cfg, device="cuda", seed=SEED)
    batch = train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                        cfg.TPU.GT_MASK_SIZE, SEED, "cuda")
    calibrate_frozen_bn(torch, model, batch["images"])
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = make_train_step(model, opt, sched, generator=gen)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    print("training: Mask R-CNN R-50-FPN, full width, bfloat16 compute, batch {} of {}x{} "
          "(image sizes {}x{}), {} gt slots, frozen-BN statistics from the batch; built in "
          "{:.1f} s".format(TRAIN_BATCH, *TRAIN_HW, *TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                            time.perf_counter() - t0), flush=True)

    def show(tag, m, dt):
        losses = {k: v.item() for k, v in m.items()}
        check(all(math.isfinite(v) for v in losses.values()), "{}: loss not finite: {}"
              .format(tag, losses))
        print("{}: {:.1f} ms, {} [{}]".format(tag, dt * 1e3, json.dumps(losses), card),
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(batch)
    torch.cuda.synchronize()
    show("warm-up step", m, time.perf_counter() - t0)

    # 8. the counted step
    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    with Capture([rpn], "match_anchors_batched") as match_cap, \
            Capture([rpn], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align", grads=True) as roi_cap:
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    show("counted step", m, dt)
    print("launches in one training step: " + json.dumps(launches), flush=True)
    expected = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2,
                "roi_align_backward_rmw": 0, "roi_align_backward_chunk": 0}
    check(launches == expected, "training step launched {}, expected {}".format(
        launches, expected))

    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        show("step {}".format(i), m, times[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    check(frozen and all(n.startswith(("backbone.body.stem.", "backbone.body.layer1."))
                         for n in frozen), "unexpected frozen parameters")
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        check(same != p.requires_grad, "{} parameter {} {} after {} steps".format(
            "trainable" if p.requires_grad else "frozen", n,
            "unchanged" if same else "changed", TIMED_STEPS + 2))
    print("after {} steps: {} trainable parameters moved, {} frozen (stem, layer1) did not"
          .format(TIMED_STEPS + 2, len(before) - len(frozen), len(frozen)), flush=True)

    # 9. kernels against their plain versions on the counted step's inputs
    check(len(match_cap.calls) == 1 and len(nms_cap.calls) == 1 and len(roi_cap.calls) == 2
          and len(roi_cap.out_grads) == 2, "captured {} matcher, {} NMS, {} ROIAlign calls"
          .format(len(match_cap.calls), len(nms_cap.calls), len(roi_cap.calls)))
    del before
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    sites = {"matcher_sites": [matcher_site(torch, matcher, *match_cap.calls[0])]}
    with torch.no_grad():
        sites["nms_sites"] = [nms_site(torch, nms, *nms_cap.calls[0], plain_iters=3)]
        sites["roi_sites"] = [roi_site(torch, poolers, [f.detach() for f in call[0]], *call[1:])
                              for call in roi_cap.calls]
    for kind in poolers.BACKWARDS:
        sites["bwd_sites_" + kind] = [
            roi_backward_site(torch, poolers, [f.detach() for f in call[0]], *call[1:],
                              roi_cap.out_grads[i], kind)
            for i, call in enumerate(roi_cap.calls)]
    del match_cap, nms_cap, roi_cap
    torch.cuda.empty_cache()
    g, n = sites["nms_sites"][0]["shape"]
    check((g, n) == (5 * TRAIN_BATCH, cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN),
          "training NMS lanes {}".format((g, n)))
    box_rois = TRAIN_BATCH * cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    mask_rois = TRAIN_BATCH * cfg.TPU.MASK_ROI_CAP
    check([(x["rois"], x["P"]) for x in sites["roi_sites"]] == [(box_rois, 7), (mask_rois, 14)]
          and all([(x["rois"], x["P"]) for x in sites["bwd_sites_" + kind]]
                  == [(box_rois, 7), (mask_rois, 14)] for kind in poolers.BACKWARDS),
          "training ROIAlign sites {}".format([(x["rois"], x["P"]) for x in sites["roi_sites"]]))
    for k in ["matcher_sites", "nms_sites", "roi_sites"] + ["bwd_sites_" + kind
                                                           for kind in poolers.BACKWARDS]:
        for site in sites[k]:
            print("training kernel site:", json.dumps(site), flush=True)

    # 10. float32 card against CPU, with the default backward and again with
    # the window backwards
    state = model.state_dict()
    train_reference_check(torch, np, cfg, state, "roi")
    window_kernels = ("roi_align_backward_rmw", "roi_align_backward_chunk")
    before = {k: counters[k].launches for k in window_kernels}
    with environ(MASKRCNN_POOLER_BWD_P7="rmw", MASKRCNN_POOLER_BWD_P14="chunk"):
        train_reference_check(torch, np, cfg, state, "rmw at P=7, chunk at P=14")
    check(all(counters[k].launches == v + 1 for k, v in before.items()),
          "the float32 check did not run the window backwards")

    # 11. throughput
    torch.backends.cudnn.allow_tf32 = True
    flops = flop_count.step_flops(
        lambda: sum(model.train_forward(batch, generator=gen).values()).backward())
    opt.zero_grad(set_to_none=True)
    step_s = sum(times) / len(times)
    mfu = flop_count.mfu_fields(flops, step_s)
    check("mfu" in mfu, "no published bf16 peak for {}".format(torch.cuda.get_device_name()))
    thr = {"img_per_s": TRAIN_BATCH / step_s, "step_ms": step_s * 1e3,
           "step_ms_each": [t * 1e3 for t in times], "flops_per_step": flops,
           "tflops_per_s": mfu["tflops_per_sec"], "mfu": mfu["mfu"],
           "peak_bf16_tflops": flop_count.device_peak_tflops(), "peak_memory_gb": peak_gb,
           "card": card}
    print("training throughput: " + json.dumps(thr), flush=True)
    print("training step peak memory: {:.3f} GB (torch.cuda.max_memory_allocated over the "
          "warm-up, counted and timed steps) [{}]".format(peak_gb, card), flush=True)
    backwards = ("roi_align_backward",) + window_kernels

    def backward_launches():
        return [counters[k].launches for k in backwards]

    # the profiled steps run the backward they were given: "roi" twice a
    # step by default, "rmw" and "chunk" once each a step with the overrides
    steps_profiled = 1
    before = backward_launches()
    prof = profiling.profile_steps(step, batch, steps_profiled)
    print("training step profile: " + json.dumps(prof), flush=True)
    check([a - b for a, b in zip(backward_launches(), before)] == [2 * steps_profiled, 0, 0],
          "the profiled default steps ran the backwards {}".format(backward_launches()))
    # the same step as the entry point runs it, "rmw" at P=7 and "chunk" at P=14
    before = backward_launches()
    with environ(MASKRCNN_POOLER_BWD_P7="rmw", MASKRCNN_POOLER_BWD_P14="chunk"):
        prof_w = profiling.profile_steps(step, batch, steps_profiled)
    print("training step profile with rmw/chunk: " + json.dumps(prof_w), flush=True)
    check([a - b for a, b in zip(backward_launches(), before)] ==
          [0, steps_profiled, steps_profiled],
          "the profiled rmw/chunk steps ran the backwards {}".format(backward_launches()))
    if prof["device_busy_ms"] != "not measured" and prof_w["device_busy_ms"] != "not measured":
        # every backward writes its gradient whole: two tile launches a step,
        # no scatter, no cast, and no memset asked for by the ROIAlign path
        # (the step's other memsets come from cuDNN, sorts and reductions,
        # whose count can differ by one between two profiled runs)
        for p_ in (prof, prof_w):
            names = p_["roi_align_kernels_per_step"]
            check(not any("cast_to_bf16" in k or "roi_align_bwd_kernel" in k or "rmw_kernel" in k
                          or "chunk_kernel" in k for k in names)
                  and sum(v for k, v in names.items() if "bwd_tile" in k) == 2,
                  "the step's ROIAlign kernels: {}".format(names))
            check(p_["roi_align_memsets_per_step"] == 0
                  and p_["roi_align_launch_calls_per_step"] >= 4,
                  "the ROIAlign path asked for {} memsets and {} launches a step".format(
                      p_["roi_align_memsets_per_step"], p_["roi_align_launch_calls_per_step"]))
    sites["launches"] = launches
    sites["throughput"] = thr
    return sites


def synthetic_coco(np, root, split="train2017", sizes=((480, 640),) * 32, seed=0,
                   category_ids=range(1, 81), ann=None):
    """A COCO-format tree under root, laid out as the dataset catalog's
    `split` (coco/<split>, coco/annotations/<ann> or instances_<split>.json): one
    image of each (h, w) of `sizes`, made from `seed` (returned as arrays by
    image id, not written: the card's machine has no image decoder), and
    annotations with bench.py's gt statistics at each image's size
    (lognormal instance counts of mean ~7, log-uniform sides of 16-500 px
    scaled by its short side / 800), each instance an octagon polygon
    inscribed in its box, of a category drawn from the JSON ids
    `category_ids`. Returns (images, annotation count, annotation file)."""
    rs = np.random.RandomState(seed)
    category_ids = list(category_ids)
    images, infos, anns = {}, [], []
    angles = np.arange(8) * np.pi / 4
    for img_id, (h, w) in enumerate(sizes, 1):
        scale = min(h, w) / 800
        images[img_id] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        infos.append({"id": img_id, "file_name": "{:06d}.jpg".format(img_id), "height": h,
                      "width": w})
        n_gt = int(np.clip(rs.lognormal(mean=1.7, sigma=0.8), 1, 100))
        side = np.exp(rs.uniform(np.log(16 * scale), np.log(500 * scale), (n_gt, 2)))
        ctr = rs.uniform(0, 1, (n_gt, 2)) * np.array([w - 1, h - 1])
        lo = np.clip(ctr - side / 2, 0, None)
        hi = np.maximum(np.minimum(ctr + side / 2, [w - 1, h - 1]), lo + 2)
        for (x0, y0), (x1, y1) in zip(lo, hi):
            cx, cy, rx, ry = (x0 + x1) / 2, (y0 + y1) / 2, (x1 - x0) / 2, (y1 - y0) / 2
            poly = np.stack([cx + rx * np.cos(angles), cy + ry * np.sin(angles)], 1)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "iscrowd": 0,
                         "category_id": category_ids[rs.randint(0, len(category_ids))],
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0)),
                         "segmentation": [poly.ravel().tolist()]})
    os.makedirs(os.path.join(root, "coco", "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "coco", split))
    ann_file = os.path.join(root, "coco", "annotations", ann or "instances_{}.json".format(split))
    write_coco_json(ann_file, infos, anns, category_ids)
    return images, len(anns), ann_file


def write_coco_json(path, infos, anns, category_ids):
    with open(path, "w") as f:
        json.dump({"images": infos, "annotations": anns,
                   "categories": [{"id": c, "name": "class{}".format(c)} for c in category_ids]},
                  f)


def config_opts(cfg, base, prefix=""):
    """KEY VALUE overrides that turn `base` into `cfg` (no YAML on the card)."""
    opts = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            opts += config_opts(v, base[k], prefix + k + ".")
        elif v != base[k]:
            opts += [prefix + k, repr(v)]
    return opts


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def entry_point_phase(torch, np, card, step_throughput, keep):
    """12-14. The training entry point, python -m maskrcnn_tpu_torch.tools.train_net, run
    in-process on the flagship at full width: the dataset catalog, COCODataset, the
    transforms, the collator, the samplers and 4 DataLoader workers over a synthetic COCO
    tree, the trainer and the checkpointer, with the "rmw" backward at P=7 and "chunk" at
    P=14. 8 iterations with a checkpoint every 4, then a resumed run to 12. The trees, the
    images and the weights are copied to `keep` for the multi-card phases."""
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.data.build import make_data_loader
    from maskrcnn_tpu_torch.data.datasets import COCODataset
    from maskrcnn_tpu_torch.models import build_detection_model, poolers
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.tools import train_net

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    load_image = COCODataset._load_image
    do_train = train_net.do_train
    logs = LogLines()
    loggers = [logging.getLogger(n) for n in ("maskrcnn_tpu_torch",
                                              "maskrcnn_tpu_torch.checkpointer")]
    for lg in loggers:  # train_net's setup_logger then adds no console handler
        lg.addHandler(logs)
        lg.setLevel(logging.INFO)
        lg.propagate = False
    try:
        # 12. data and weights
        images, n_anns, _ = synthetic_coco(np, work)
        val_images, n_val, _ = synthetic_coco(np, work, "val2017", ((480, 640),) * VAL_IMAGES,
                                              seed=SEED + 1)
        trees = {"train2017": images, "val2017": val_images}
        COCODataset._load_image = (
            lambda self, index: trees[os.path.basename(self.root)][self.ids[index]])
        print("entry point: synthetic COCO trees of {} (train) and {} (val) images of 480x640 "
              "(seeds {} and {}), {} and {} polygon instances; COCODataset._load_image "
              "overridden to hand over the seeded arrays (no image decoder on the card)".format(
                  len(images), len(val_images), SEED, SEED + 1, n_anns, n_val), flush=True)
        cfg = flagship_cfg()
        model = build_detection_model(cfg, device="cuda", seed=SEED)
        first = torch.from_numpy(np.stack([images[i] for i in range(1, 9)])).cuda()
        sizes = torch.tensor([[480, 640]] * 8, dtype=torch.int32, device="cuda")
        calibrate_frozen_bn(torch, model, model._prepare_images(first, sizes))
        weights = os.path.join(work, "weights.pth")
        torch.save({"model": model.state_dict()}, weights)
        keep_tree(keep, work, weights, trees)
        del model, first
        torch.cuda.empty_cache()
        out = os.path.join(work, "out")
        opts = config_opts(cfg, defaults) + [
            "MODEL.DEVICE", "cuda", "MODEL.WEIGHT", weights,
            "DATASETS.TRAIN", "('coco_2017_train',)", "SOLVER.IMS_PER_BATCH", "8",
            "INPUT.MIN_SIZE_TRAIN", "(800,)",
            "INPUT.MAX_SIZE_TRAIN", "1333", "SOLVER.CHECKPOINT_PERIOD", "4",
            "DATALOADER.NUM_WORKERS", "4", "OUTPUT_DIR", out]
        print("entry point: train_net --skip-test " + " ".join(opts) + " SOLVER.MAX_ITER 8, with "
              "MASKRCNN_POOLER_BWD_P7=rmw MASKRCNN_POOLER_BWD_P14=chunk; MODEL.WEIGHT: the "
              "seeded init with frozen-BN statistics from 8 of the images", flush=True)

        def logged_iterations():
            its = [int(m) for line in logs.lines for m in re.findall(r"iter: (\d+)", line)]
            logs.lines.clear()
            return its

        # 13. eight iterations through the entry point, 44. iterations 2-7
        # under the trainer's trace hook
        counters = training_counters(poolers, matcher, nms)
        trace_dir = os.path.join(work, "trace")
        with environ(MASKRCNN_TPU_DATA_DIR=work, MASKRCNN_POOLER_BWD_P7="rmw",
                     MASKRCNN_POOLER_BWD_P14="chunk", MASKRCNN_TPU_PROFILE_DIR=trace_dir,
                     MASKRCNN_TPU_PROFILE_AT=str(TRACE_AT)):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            _, meters = train_net.main(["--skip-test"] + opts + ["SOLVER.MAX_ITER", "8"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            lines = list(logs.lines)
            its = logged_iterations()
            for line in lines:
                if "iter:" in line or "non-finite" in line or "skipped" in line:
                    print("  train_net: " + line, flush=True)
            print("entry point launches in 8 iterations: " + json.dumps(launches), flush=True)
            per_step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 0,
                        "roi_align_backward_rmw": 1, "roi_align_backward_chunk": 1}
            check(launches == {k: 8 * v for k, v in per_step.items()},
                  "entry point launched {}, expected {} a step".format(launches, per_step))
            check(its == [8], "the first run logged iterations {}".format(its))
            for name in ("model_0000004.pth", "model_final.pth", "last_checkpoint"):
                check(os.path.exists(os.path.join(out, name)),
                      "no {} after 8 iterations".format(name))
            losses = {k: m.global_avg for k, m in meters.meters.items() if k.startswith("loss")}
            check(len(losses) == 6 and all(math.isfinite(v) for v in losses.values()),
                  "entry point losses {}".format(losses))
            times = list(meters.meters["time"].deque)
            waits = list(meters.meters["data"].deque)
            step_s = meters.meters["time"].median
            trace_hook_phase(card, lines, trace_dir, times)
            # the loader alone at the same settings, past its first batch
            lcfg = defaults.clone()
            lcfg.merge_from_list(opts + ["SOLVER.MAX_ITER", "25"])
            n_batches = 0
            for _ in make_data_loader(lcfg, is_train=True):
                n_batches += 1
                if n_batches == 1:
                    t_first = time.perf_counter()
            loader_s = (time.perf_counter() - t_first) / (n_batches - 1)
            thr = {"s_per_iter_median": step_s, "s_per_iter_each": times,
                   "img_per_s": 8 / step_s, "data_time_share": sum(waits) / sum(times),
                   "data_time_share_after_first": sum(waits[1:]) / sum(times[1:]),
                   "data_s_each": waits, "wall_s": wall,
                   "loader_alone_s_per_batch": loader_s, "loader_alone_img_per_s": 8 / loader_s,
                   "make_train_step_img_per_s": step_throughput["img_per_s"], "card": card}
            print("entry point throughput: " + json.dumps(thr), flush=True)

            # 14. resume to 12 from model_final
            final = os.path.join(out, "model_final.pth")
            saved = torch.load(final, map_location="cpu", weights_only=True)
            check(saved["iteration"] == 8, "model_final holds iteration {}".format(
                saved["iteration"]))
            start = {}

            def recording(model, optimizer, *args, **kwargs):
                start.update((k, v.detach().cpu().clone()) for k, v in model.state_dict().items())
                return do_train(model, optimizer, *args, **kwargs)

            train_net.do_train = recording
            t0 = time.perf_counter()
            _, meters2 = train_net.main(opts + [
                "SOLVER.MAX_ITER", "12", "SOLVER.TEST_PERIOD", "4",
                "DATASETS.TEST", "('coco_2017_val',)", "TEST.IMS_PER_BATCH", "8"])
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            lines2 = list(logs.lines)
            resumed = any("Loading checkpoint from " + final in line for line in lines2)
            its2 = logged_iterations()
        check(resumed, "the resumed run did not load {}".format(final))
        # validation (bbox) at the period, then the final test (bbox, segm)
        marks = [line for line in lines2 if line.startswith(
            ("Validation at iteration", "Evaluating predictions", "Start evaluation"))]
        start_line = "Start evaluation on coco_2017_val dataset({} images).".format(VAL_IMAGES)
        want = ["Validation at iteration 12", start_line, "Evaluating predictions: bbox",
                start_line, "Evaluating predictions: bbox", "Evaluating predictions: segm"]
        check(marks == want, "the resumed train_net validated and tested as {}".format(marks))
        for line in lines2:
            if line.startswith(("Validation", "Total run time", "Model inference time",
                                "bbox: ", "segm: ")):
                print("  train_net: " + line, flush=True)
        print("entry point: the resumed run (9-12, SOLVER.TEST_PERIOD 4, no --skip-test) "
              "validated after iteration 12 and ran the final test on {} images in {:.1f} s "
              "[{}]".format(VAL_IMAGES, wall2, card), flush=True)
        check(its2 and min(its2) >= 9, "the resumed run logged iterations {}".format(its2))
        check(set(start) == set(saved["model"]) and all(
            torch.equal(start[k], v) for k, v in saved["model"].items()),
            "the resumed run did not start from the saved parameters")
        losses2 = {k: m.global_avg for k, m in meters2.meters.items() if k.startswith("loss")}
        check(all(math.isfinite(v) for v in losses2.values()), "resumed losses {}".format(losses2))
        print("entry point resume: loaded model_final (iteration 8), {} parameters and buffers "
              "equal to the saved ones, logged iterations {}, losses {}".format(
                  len(start), its2, json.dumps(losses2)), flush=True)
        return {"launches": launches}
    finally:
        COCODataset._load_image = load_image
        train_net.do_train = do_train
        for lg in loggers:
            lg.removeHandler(logs)
        shutil.rmtree(work, ignore_errors=True)


def trace_hook_phase(card, lines, trace_dir, times):
    """44. The trainer's trace hook in phase 13's run (MASKRCNN_TPU_PROFILE_AT
    TRACE_AT): rank 0's Chrome trace exists and holds the ranges of
    iterations TRACE_AT to TRACE_AT + 5 and no other, device kernels, and
    every phase range of the flagship's training step; the records of each
    hand kernel it kept (not gated: torch.profiler drops some); the run's
    s/iter on and off the traced iterations."""
    from maskrcnn_tpu_torch.utils.profiling import HAND_KERNELS

    path = os.path.join(trace_dir, "rank0.pt.trace.json")
    check(os.path.exists(path) and os.listdir(trace_dir) == ["rank0.pt.trace.json"],
          "the trace hook wrote {}".format(os.listdir(trace_dir) if os.path.isdir(trace_dir)
                                            else "nothing"))
    check(any("profiler trace written to " + path in line for line in lines),
          "the trainer did not log the trace's path")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = {"iteration {}".format(i) for i in range(TRACE_AT, TRACE_AT + 6)}
    check({r for r in ranges if r.startswith("iteration ")} == traced,
          "the trace holds the iterations {}".format(sorted(r for r in ranges
                                                            if r.startswith("iteration "))))
    check(kernels, "the trace holds no device kernel")
    missing = set(TRAIN_PHASES) - ranges
    check(not missing, "the trace lacks the phase ranges {}".format(sorted(missing)))
    kept = {k: sum(k in n for n in kernels) for k in HAND_KERNELS}
    # launches a step at phase 13's settings: NMS (mask, reduce) 1, ROIAlign
    # forward 2, the rmw and chunk backwards' tile kernel 2, the matcher 1
    expected = {"nms_mask_kernel": 6, "nms_reduce_kernel": 6, "roi_align_fwd_kernel": 12,
                "roi_align_bwd_tile_kernel": 12, "matcher_kernel": 6}
    off = [times[i] for i in range(len(times)) if not TRACE_AT - 1 <= i < TRACE_AT + 5]
    on = times[TRACE_AT - 1:TRACE_AT + 5]
    print("trace hook: {} ({:.1f} MB): iterations {}-{}, {} device kernels, every training "
          "phase range; hand-kernel records kept {} of {} launched; s/iter traced (the last "
          "writes the trace) {}, untraced (iteration 1 is the first) {} [{}]".format(
              path, os.path.getsize(path) / 1e6, TRACE_AT, TRACE_AT + 5, len(kernels),
              json.dumps(kept), json.dumps(expected), json.dumps(on), json.dumps(off), card),
          flush=True)


def profiling_phase(torch, np, card, step_ms, serving_ms):
    """45-46. tools/profile_train.py on the flagship (train and --infer), then
    the paths no earlier phase runs: X-101-32x8d training and X-152-32x8d
    serving through profile_train's builders, and a Keypoint R-CNN request
    decoded on the device. Returns the launches and kernel sites by path."""
    from torch.profiler import record_function

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.models import detector, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.models.roi_heads import keypoint_head as kh
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.predictor import Predictor
    from maskrcnn_tpu_torch.tools import profile_train
    from maskrcnn_tpu_torch.utils import profiling

    counters = training_counters(poolers, matcher, nms)
    launches, sites, phase_s = {}, {}, {}

    def counted(path, fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[path] = {k: c.launches for k, c in counters.items()}
        return out

    def profiled(path, build, b, phases):
        """profile_train's reading of the flagship (frozen BN calibrated from
        its batch): the phase ranges and the unattributed time add up to
        the device busy time within 2%; every phase of `phases` read."""
        step, model, batch = build(b)
        calibrate_frozen_bn(torch, model, batch["images"])
        res = profile_train.measure(step, batch, "cuda")
        profile_train.report(res, b, card, top_n=15)
        linked, busy = sum(res["phases"].values()), res["device_busy_ms"]
        check(abs(linked - busy) <= 0.02 * busy and 0 <= res["idle_share"] <= 1,
              "{}: phases and unattributed {} ms against a device busy {} ms".format(
                  path, linked, busy))
        # a phase's device time is its own and its dotted parts' (PORT_SPANS)
        missing = {p for p in phases
                   if not any(k == p or k.startswith(p + ".") for k in res["phases"])}
        check(not missing, "{}: no device time under the ranges {}".format(path, missing))
        shares = {k: {"ms": v, "share": v / busy} for k, v in res["phases"].items()}
        print("{} by JAX's phase names, torch.profiler, 3 steps [{}]: {}".format(
            path, card, json.dumps({"step_ms": res["step_s"] * 1e3, "wall_ms": res["wall_ms"],
                                    "device_busy_ms": busy, "idle_share": res["idle_share"],
                                    "linked_ms": linked, "phases": shares,
                                    "families": res["families"]})), flush=True)
        del step, model, batch
        torch.cuda.empty_cache()

    # 45. profile_train on the flagship
    t0 = time.perf_counter()
    profiled("profile_train (flagship train step, batch 8)", profile_train.build_step,
             TRAIN_BATCH, set(TRAIN_PHASES) - {"image_prep"})
    profiled("profile_train --infer (flagship, batch 1)", profile_train.build_infer, 1,
             {"backbone", "stem", "layer1", "layer2", "layer3", "layer4", "fpn", "rpn_head",
              "proposals", "box_head", "box_postproc", "mask_head"})
    # the spans' own host cost with nothing recording: an empty span entered
    # and left (what the model pays), beside a record_function range opened
    # untraced (what it paid before profiling.span)
    def per_range_us(make):
        t1 = time.perf_counter()
        for _ in range(10000):
            with make("phase"):
                pass
        return (time.perf_counter() - t1) * 1e2

    span_us, range_us = per_range_us(profiling.span), per_range_us(record_function)
    print("with the spans: phase 11's step {} ms (the last recorded run without ranges: "
          "{} ms), serving latency at seen shapes {} ms; one span {} us on the host with "
          "nothing recording, a record_function range opened so {} us [{}]".format(
              step_ms, UNRANGED_STEP_MS, json.dumps(serving_ms), span_us, range_us, card),
          flush=True)
    phase_s["profile_train"] = time.perf_counter() - t0

    # 46. X-101-32x8d Mask R-CNN trains at batch 8, remat "auto" on
    t0 = time.perf_counter()
    with environ(MASKRCNN_TPU_PROFILE_CONFIG=os.path.join(
            REPO, "configs", "e2e_mask_rcnn_X_101_32x8d_FPN_1x.yaml")):
        step, model, batch = profile_train.build_step(TRAIN_BATCH)
    body = model.backbone.body
    check(body.remat and model.cfg.MODEL.RESNETS.NUM_GROUPS == 32
          and sum(len(getattr(body, n)) for n in body.stage_names) == 33,
          "X-101-32x8d: {} blocks, remat {}".format(
              sum(len(getattr(body, n)) for n in body.stage_names), body.remat))
    calibrate_frozen_bn(torch, model, batch["images"])
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    torch.cuda.reset_peak_memory_stats()
    losses = [{k: v.item() for k, v in step(batch).items()}]
    with Capture([rpn], "match_anchors_batched") as match_cap, \
            Capture([rpn], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align", grads=True) as roi_cap:
        m = counted("x101_training", lambda: step(batch))
    losses.append({k: v.item() for k, v in m.items()})
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append({k: v.item() for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for it in losses for v in it.values()),
          "X-101 losses {}".format(losses))
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()
                if p.requires_grad)
    check(moved == len(before), "X-101: {} of {} trainable parameters moved".format(
        moved, len(before)))
    check(launches["x101_training"] == {"matcher": 1, "nms": 1, "roi_align": 2,
                                        "roi_align_backward": 2, "roi_align_backward_rmw": 0,
                                        "roi_align_backward_chunk": 0},
          "X-101 step launched {}".format(launches["x101_training"]))
    del before, m
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    got = {"matcher": [matcher_site(torch, matcher, *match_cap.calls[0])]}
    with torch.no_grad():
        got["nms"] = [nms_site(torch, nms, *nms_cap.calls[0], plain_iters=3)]
        got["roi_align"] = [roi_site(torch, poolers, [f.detach() for f in c[0]], *c[1:])
                            for c in roi_cap.calls]
    got["roi_align_backward"] = [
        roi_backward_site(torch, poolers, [f.detach() for f in c[0]], *c[1:],
                          roi_cap.out_grads[i], "roi") for i, c in enumerate(roi_cap.calls)]
    sites["x101_training"] = got
    del match_cap, nms_cap, roi_cap, step, model, batch
    torch.cuda.empty_cache()
    print("X-101-32x8d Mask R-CNN (configs/e2e_mask_rcnn_X_101_32x8d_FPN_1x.yaml, seeded, "
          "frozen BN from the batch) through profile_train.build_step at batch 8 of 800x1344, "
          "remat auto (each trainable block recomputed): ms a step {}, peak {:.3f} GB, all "
          "{} trainable parameters moved, launches a step {}, losses {} [{}]".format(
              json.dumps(times), peak_gb, moved, json.dumps(launches["x101_training"]),
              json.dumps(losses[-1]), card), flush=True)
    for kind, ss in got.items():
        for site in ss:
            print("x101 training kernel site ({}): {}".format(kind, json.dumps(site)),
                  flush=True)
    phase_s["x101_training"] = time.perf_counter() - t0

    # 46. the X-152-32x8d caffe2 file serves a few requests
    t0 = time.perf_counter()
    with environ(MASKRCNN_TPU_PROFILE_CONFIG=os.path.join(
            REPO, "configs", "caffe2", "e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x_caffe2.yaml")):
        infer, model, batch = profile_train.build_infer(1)
    body = model.backbone.body
    check(sum(len(getattr(body, n)) for n in body.stage_names) == 50
          and model.cfg.MODEL.RESNETS.NUM_GROUPS == 32, "X-152-32x8d: not 50 grouped blocks")
    calibrate_frozen_bn(torch, model, batch["images"])
    torch.cuda.reset_peak_memory_stats()
    infer(batch)
    torch.cuda.synchronize()
    with Capture([rpn, box_head], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align") as roi_cap:
        det = counted("x152_serving", lambda: infer(batch))
    latencies = []
    for _ in range(3):
        t1 = time.perf_counter()
        det = infer(batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t1) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = int(det["valid"].sum())
    check(0 < n and all(torch.isfinite(det[k]).all() for k in ("boxes", "scores", "masks"))
          and tuple(det["masks"].shape[2:]) == (28, 28),
          "X-152 request: {} detections, {}".format(n, {k: tuple(v.shape)
                                                        for k, v in det.items()}))
    check(launches["x152_serving"]["nms"] == 2 and launches["x152_serving"]["roi_align"] == 2
          and sum(launches["x152_serving"].values()) == 4,
          "X-152 request launched {}".format(launches["x152_serving"]))
    with torch.inference_mode():
        sites["x152_serving"] = {
            "nms": [nms_site(torch, nms, *c, plain_iters=3) for c in nms_cap.calls],
            "roi_align": [roi_site(torch, poolers, *c) for c in roi_cap.calls]}
    del nms_cap, roi_cap, infer, model, batch, det
    torch.cuda.empty_cache()
    print("X-152-32x8d caffe2 Mask R-CNN (seeded, frozen BN from the image) through "
          "profile_train.build_infer, one 800x1333 image a request: latency ms {}, {} "
          "detections, peak {:.3f} GB, launches a request {} [{}]".format(
              json.dumps(latencies), n, peak_gb, json.dumps(launches["x152_serving"]), card),
          flush=True)
    for kind, ss in sites["x152_serving"].items():
        for site in ss:
            print("x152 serving kernel site ({}): {}".format(kind, json.dumps(site)), flush=True)
    phase_s["x152_serving"] = time.perf_counter() - t0

    # 46. a Keypoint R-CNN request decoded on the device
    t0 = time.perf_counter()
    cfg = defaults.clone()
    cfg.merge_from_file(os.path.join(REPO, "configs", "e2e_keypoint_rcnn_R_50_FPN_1x.yaml"))
    cfg.MODEL.WEIGHT = ""
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = True
    pred = Predictor(cfg, device="cuda", seed=SEED + 18, min_image_size=cfg.INPUT.MIN_SIZE_TEST)
    rs = np.random.RandomState(SEED + 18)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    image = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    calibrate_frozen_bn(torch, pred.model, pred.preprocess(warm)[0])
    gen = torch.Generator().manual_seed(SEED + 19)
    with torch.no_grad():  # phase 31's redraw: spread scores and heatmaps
        for k, v in pred.model.state_dict().items():
            if k.endswith(".weight") and k.startswith(("roi_heads.keypoint.",
                                                       "roi_heads.box.predictor.cls_score")):
                if "kps_score_lowres" in k:
                    gain, fan_in = 10.0, v.shape[0] * 4
                else:
                    gain, fan_in = (10.0 if "cls_score" in k else 2 ** 0.5), v[0].numel()
                v.copy_(torch.randn(v.shape, generator=gen).to(v) * gain / fan_in ** 0.5)
    pred.compute_prediction(warm)
    t1 = time.perf_counter()
    out = counted("keypoint_device_decode", lambda: pred.compute_prediction(image))
    device_request_ms = (time.perf_counter() - t1) * 1e3
    check(launches["keypoint_device_decode"]["nms"] == 2
          and launches["keypoint_device_decode"]["roi_align"] == 2
          and sum(launches["keypoint_device_decode"].values()) == 4,
          "keypoint request launched {}".format(launches["keypoint_device_decode"]))
    k = len(out["scores"])
    check(k > 0 and out["keypoints"].shape == (k, 17, 4) and np.isfinite(out["keypoints"]).all(),
          "device-decoded request: {} detections, keypoints {}".format(
              k, out["keypoints"].shape))
    # the request's heatmaps and boxes, at the model's input scale
    images, image_sizes = pred.preprocess(image)
    with Capture([detector], "heatmaps_to_keypoints") as dec_cap:
        det = pred.model.infer_forward({"images": images, "image_sizes": image_sizes})
    logits, rois = dec_cap.calls[0]
    dev = kh.heatmaps_to_keypoints(logits, rois)
    plain = kh.heatmaps_to_keypoints(logits.cpu(), rois.cpu())
    err = (dev.cpu() - plain)[..., :2].abs().max().item()
    check(err <= 1e-4, "device decode on the card off its CPU run by {} px".format(err))
    valid = det["valid"][0]
    maps = logits[valid].permute(0, 2, 3, 1).float().cpu().numpy()
    boxes = rois[valid].cpu().numpy()
    t1 = time.perf_counter()
    exact = kh.heatmaps_to_keypoints_exact(maps, boxes)
    host_ms = (time.perf_counter() - t1) * 1e3
    dev_np = dev[valid].cpu().numpy()
    side = np.maximum(boxes[:, 2:] - boxes[:, :2], 1.0)[:, None, :] / logits.shape[-1]
    bins = (np.abs(dev_np[..., :2] - exact[..., :2]) / side).max(-1)
    pred.model.cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = False
    t1 = time.perf_counter()
    host_out = pred.compute_prediction(image)
    host_request_ms = (time.perf_counter() - t1) * 1e3
    check(host_out["keypoints"].shape == out["keypoints"].shape,
          "the host-decoded request: keypoints {}".format(host_out["keypoints"].shape))
    res = {"detections": k, "device_decode_ms": cuda_ms(
               torch, lambda: kh.heatmaps_to_keypoints(logits, rois), 20),
           "device_decode_rois": int(rois.shape[0]), "host_decode_ms": host_ms,
           "host_decode_rois": int(valid.sum()), "device_vs_cpu_px": err,
           "joints_within_one_heatmap_bin_of_host": float((bins <= 1).mean()),
           "max_bins_from_host": float(bins.max()),
           "max_abs_score_diff": float(np.abs(dev_np[..., 3] - exact[..., 3]).max()),
           "request_ms_device_decode": device_request_ms,
           "request_ms_host_decode": host_request_ms}
    print("keypoint request decoded on the device (configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml, "
          "TPU.KEYPOINT_DECODE_ON_DEVICE True, seeded, heads redrawn as phase 31): launches {}, "
          "against the exact host decode on the same heatmaps [{}]: {}".format(
              json.dumps(launches["keypoint_device_decode"]), card, json.dumps(res)), flush=True)
    del pred, dec_cap, det, logits, rois, dev
    torch.cuda.empty_cache()
    phase_s["keypoint_device_decode"] = time.perf_counter() - t0
    return {"launches": launches, "sites": sites, "phase_s": phase_s}


def test_size(h, w, min_size=800, max_size=1333):
    """(h, w) of an image after the test transform's resize (the reference's
    Resize.get_size: the short side to min_size unless the long side would
    pass max_size; the long side truncated)."""
    size = min_size
    if max(h, w) / min(h, w) * size > max_size:
        size = int(round(max_size * min(h, w) / max(h, w)))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    return (int(size * h / w), size) if w < h else (size, int(size * w / h))


def evaluation_phase(torch, np, card, keep):
    """15-19. Evaluation through python -m maskrcnn_tpu_torch.tools.test_net, in-process, on
    the flagship at full width (bf16) over a synthetic COCO val tree of 32 images at
    TEST.IMS_PER_BATCH 8: the kernels at the evaluation shapes, a known-answer pass, and
    the card against the CPU on a test batch. The known-answer tree, its images, the weights
    and the test options are copied to `keep` for the multi-card phases."""
    import pickle

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.data.datasets import COCODataset
    from maskrcnn_tpu_torch.data.evaluation import coco_eval, cocoeval
    from maskrcnn_tpu_torch.engine import inference as inference_mod
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.tools import test_net

    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    load_image = COCODataset._load_image
    wrapped = {"prepare_for_coco_detection": coco_eval, "prepare_for_coco_segmentation": coco_eval,
               "detections_to_boxlists": inference_mod}
    saved = {name: getattr(mod, name) for name, mod in wrapped.items()}
    evaluate = cocoeval.COCOEvaluator.evaluate
    logs = LogLines()
    logger = logging.getLogger("maskrcnn_tpu_torch")
    logger.addHandler(logs)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    host_s, raw = [], []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host_s.append((name, time.perf_counter() - t0))
            return out
        return wrapper

    def recording(det, image_sizes):
        raw.append(({k: np.asarray(v) for k, v in det.items()}, np.asarray(image_sizes)))
        return saved["detections_to_boxlists"](det, image_sizes)

    def evaluate_timed(self, predictions):
        return timed("COCOEvaluator.evaluate " + self.iou_type, evaluate)(self, predictions)

    try:
        # 15. the tree and the weights
        images, n_anns, ann_file = synthetic_coco(np, work, "val2017", EVAL_SIZES, seed=SEED + 2,
                                                  category_ids=COCO_CATEGORY_IDS)
        COCODataset._load_image = lambda self, index: images[self.ids[index]]
        cfg = flagship_cfg()
        model = build_detection_model(cfg, device="cuda", seed=SEED)
        first = torch.from_numpy(np.stack([images[i] for i in range(1, 9)])).cuda()
        sizes = torch.tensor([EVAL_SIZES[0]] * 8, dtype=torch.int32, device="cuda")
        calibrate_frozen_bn(torch, model, model._prepare_images(first, sizes))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        weights = os.path.join(work, "weights.pth")
        torch.save({"model": state}, weights)
        del model, first
        torch.cuda.empty_cache()
        opts = config_opts(cfg, defaults) + [
            "MODEL.DEVICE", "cuda", "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
            "DATASETS.TEST", "('coco_2017_val',)", "TEST.IMS_PER_BATCH", str(EVAL_BATCH),
            "INPUT.MIN_SIZE_TEST", "800", "INPUT.MAX_SIZE_TEST", "1333",
            "DATALOADER.NUM_WORKERS", "4"]
        out = os.path.join(work, "out")
        print("evaluation: synthetic COCO val tree of {} images (16 of 480x640, then 16 of "
              "640x480; seed {}), {} polygon instances over COCO's 80 sparse category ids; "
              "test_net --ckpt <seeded flagship, frozen-BN statistics from 8 of the images> {} "
              "OUTPUT_DIR <dir>".format(len(images), SEED + 2, n_anns, " ".join(opts)),
              flush=True)

        # 16. the first pass: bbox and segm
        counters = training_counters(poolers, matcher, nms)
        for fn in counters.values():
            fn.launches = 0
        coco_eval.prepare_for_coco_detection = timed("prepare_for_coco_detection",
                                                     saved["prepare_for_coco_detection"])
        coco_eval.prepare_for_coco_segmentation = timed("prepare_for_coco_segmentation",
                                                        saved["prepare_for_coco_segmentation"])
        cocoeval.COCOEvaluator.evaluate = evaluate_timed
        inference_mod.detections_to_boxlists = recording
        with environ(MASKRCNN_TPU_DATA_DIR=work), \
                Capture([rpn, box_head], "batched_nms", limit=2) as nms_cap, \
                Capture([detector], "multilevel_roi_align", limit=2) as roi_cap:
            t0 = time.perf_counter()
            ((res, _),) = test_net.main(["--ckpt", weights] + opts + ["OUTPUT_DIR", out])
            wall = time.perf_counter() - t0
        inference_mod.detections_to_boxlists = saved["detections_to_boxlists"]
        launches = {k: fn.launches for k, fn in counters.items()}
        batches = len(EVAL_SIZES) // EVAL_BATCH
        print("evaluation launches in {} batches: {}".format(batches, json.dumps(launches)),
              flush=True)
        check(launches == {k: (2 * batches if k in ("nms", "roi_align") else 0)
                           for k in counters},
              "evaluation launched {}, expected NMS and ROIAlign twice a batch".format(launches))
        check(len(raw) == batches, "{} batches read back, expected {}".format(len(raw), batches))
        timing = {}
        for line in logs.lines:
            m = re.match(r"Total run time: ([\d.]+) s \(([\d.]+) s / img", line)
            if m:
                timing["total_s"], timing["total_s_per_img"] = float(m[1]), float(m[2])
            m = re.match(r"Model inference time: ([\d.]+) s / img", line)
            if m:
                timing["model_s_per_img"] = float(m[1])
        check(len(timing) == 3, "no inference timing lines in the log")
        timing.update({name: t for name, t in host_s})
        timing["test_net_wall_s"] = wall
        aps = {k: dict(v) for k, v in res.results.items()}
        print("evaluation timing [{}]: {}".format(card, json.dumps(timing)), flush=True)
        print("evaluation AP (random weights) [{}]: {}".format(card, json.dumps(aps)), flush=True)
        check(set(aps) == {"bbox", "segm"} and all(
            math.isfinite(v) and -1 <= v <= 1 for d in aps.values() for v in d.values()),
            "evaluation results {}".format(aps))

        # 17. the kernels at the evaluation shapes, on the first batch's inputs
        with torch.inference_mode():
            nms_sites = [dict(nms_site(torch, nms, *call, plain_iters=3), launches=batches)
                         for call in nms_cap.calls]
            roi_sites = [dict(roi_site(torch, poolers, *call), launches=batches)
                         for call in roi_cap.calls]
        del nms_cap, roi_cap
        torch.cuda.empty_cache()
        dets = cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
        check([s_["shape"] for s_ in nms_sites]
              == [[5 * EVAL_BATCH, cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST],
                  [EVAL_BATCH * (cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1),
                   min(cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST, max(2 * dets, 128))]],
              "evaluation NMS lanes {}".format([s_["shape"] for s_ in nms_sites]))
        check([(s_["rois"], s_["P"]) for s_ in roi_sites]
              == [(EVAL_BATCH * cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST, 7), (EVAL_BATCH * dets, 14)],
              "evaluation ROIAlign sites {}".format([(s_["rois"], s_["P"]) for s_ in roi_sites]))
        for site in nms_sites + roi_sites:
            print("evaluation kernel site [{}]: {}".format(card, json.dumps(site)), flush=True)

        # 18. known answer: the first pass's detections, resized here to their
        # images' original sizes, become the tree's gt; a second pass on the
        # same images and weights (boxes only) must find them. Those under a
        # pixel a side (proposals in a bucket's padding, clipped to the
        # image's edge: random weights rank them anywhere) get their gt too,
        # or they would count as false positives among the rest.
        with open(os.path.join(out, "inference", "coco_2017_val", "predictions.pkl"), "rb") as f:
            preds = pickle.load(f)
        json_ids = sorted(COCO_CATEGORY_IDS)
        gts, degenerate = [], 0
        for b, (det, image_sizes) in enumerate(raw):
            for i in range(len(image_sizes)):
                index = b * EVAL_BATCH + i  # the sequential sampler's order
                h, w = EVAL_SIZES[index]
                rh, rw = test_size(h, w)
                check(tuple(image_sizes[i]) == (rh, rw), "batch {} image {} resized to {}".format(
                    b, i, image_sizes[i]))
                for box, label in zip(det["boxes"][i][det["valid"][i]],
                                      det["labels"][i][det["valid"][i]]):
                    x0, x1 = (float(v) * w / rw for v in box[0::2])
                    y0, y1 = (float(v) * h / rh for v in box[1::2])
                    degenerate += x1 - x0 < 1 or y1 - y0 < 1
                    gts.append({"id": len(gts) + 1, "image_id": index + 1, "iscrowd": 0,
                                "category_id": json_ids[int(label) - 1],
                                "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                                "area": (x1 - x0 + 1) * (y1 - y0 + 1),
                                "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]]})
        infos = [{"id": i + 1, "file_name": "{:06d}.jpg".format(i + 1), "height": h, "width": w}
                 for i, (h, w) in enumerate(EVAL_SIZES)]
        write_coco_json(ann_file, infos, gts, COCO_CATEGORY_IDS)
        keep_tree(keep, work, weights, {"val2017": images}, opts + ["MODEL.MASK_ON", "False"])
        out2 = os.path.join(work, "out2")
        with environ(MASKRCNN_TPU_DATA_DIR=work):
            ((res2, _),) = test_net.main(["--ckpt", weights] + opts + [
                "MODEL.MASK_ON", "False", "OUTPUT_DIR", out2])
        with open(os.path.join(out2, "inference", "coco_2017_val", "predictions.pkl"), "rb") as f:
            preds2 = pickle.load(f)
        check(len(preds) == len(preds2) == len(EVAL_SIZES), "predictions for {} and {} images"
              .format(len(preds), len(preds2)))
        errs = {"score": 0.0, "box_px": 0.0}
        for a, b in zip(preds, preds2):
            check(len(a) == len(b) and (a.get_field("labels") == b.get_field("labels")).all(),
                  "the second pass's detections differ in number or labels")
            errs["score"] = max(errs["score"], float(np.abs(
                a.get_field("scores") - b.get_field("scores")).max(initial=0)))
            errs["box_px"] = max(errs["box_px"], float(np.abs(a.bbox - b.bbox).max(initial=0)))
        known = {"gt_from_detections": len(gts), "of_them_under_1px": degenerate,
                 "bbox": dict(res2.results["bbox"]), "second_pass_max_err": errs}
        print("evaluation known answer [{}]: {}".format(card, json.dumps(known)), flush=True)
        check(errs["score"] <= 1e-5 and errs["box_px"] <= 1e-3,
              "the second pass's detections differ from the first's by {}".format(errs))
        check(res2.results["bbox"]["AP50"] >= 0.99, "known-answer bbox AP50 {} < 0.99".format(
            res2.results["bbox"]["AP50"]))

        # 19. the card against the CPU in float32 on a test batch of two
        # images of different sizes (crops of a landscape and a portrait one),
        # at the serving check's tolerances; the agreement at the CPU parity
        # tests' (scores 1e-5, boxes 1e-3 px) is reported: on such a batch the
        # two sides' scores of one box differ by up to ~1e-4 (PERF.md)
        crops = [images[1][:250, :310], images[17][:300, :224]]
        batch = np.zeros((2, 320, 320, 3), np.uint8)
        for i, im in enumerate(crops):
            batch[i, :im.shape[0], :im.shape[1]] = im
        c = flagship_cfg()
        c.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
        ref = reference_check(torch, np, detector, c, state, batch,
                              np.asarray([im.shape[:2] for im in crops], np.int32),
                              report_tols=[(1e-5, 1e-3, 1e-3)])
        print("evaluation float32 card vs CPU on a batch of 250x310 and 300x224: "
              + json.dumps(ref), flush=True)
        check(ref["agree"] >= 0.9, "card and CPU disagree on {:.1%} of an image's detections"
              .format(1 - ref["agree"]))
        return {"launches": launches, "nms_sites": nms_sites, "roi_sites": roi_sites}
    finally:
        COCODataset._load_image = load_image
        for name, mod in wrapped.items():
            setattr(mod, name, saved[name])
        cocoeval.COCOEvaluator.evaluate = evaluate
        logger.removeHandler(logs)
        shutil.rmtree(work, ignore_errors=True)


def fold_frozen_bn(torch, model):
    """Fold every frozen BN's statistics into its affine pair (weight
    w / sqrt(var), bias b - mean * that; mean 0, var 1): the same function,
    in the form a Detectron file holds it."""
    from maskrcnn_tpu_torch.models.layers import FrozenBatchNorm2d

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                s = m.weight * torch.rsqrt(m.running_var)
                m.bias.copy_(m.bias - m.running_mean * s)
                m.weight.copy_(s)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def imagenet_expected(np, body):
    """The port's body tensors that a Detectron ImageNet file of `body`
    loads: the convs as they are, each frozen BN as its affine pair with
    the running mean and variance at their init (0 and 1)."""
    out = dict(body)
    for k in body:
        if k.endswith(".running_mean"):
            p = k[:-len(".running_mean")]
            s = body[p + ".weight"] / np.sqrt(body[p + ".running_var"])
            out[p + ".weight"], out[p + ".bias"] = s, body[p + ".bias"] - body[k] * s
            out[k] = np.zeros_like(s)
            out[p + ".running_var"] = np.ones_like(s)
    return out


def synthetic_cityscapes(np, root, split, frames, seed):
    """A Cityscapes tree under root/cityscapes (leftImg8bit/<split>/smoke,
    gtFine/<split>/smoke) of `frames` 2048x1024 frames made from `seed`, each
    with 20-39 instances of the classes person to train (label ids 24-31)
    drawn as ellipses of 24-320 x 24-240 px whose boxes overlap no earlier
    one's by an IoU above 0.3 (so that no prediction equal to one instance
    matches another: the evaluator's known answer is 1), later ones in front:
    the
    *_polygons.json as 16-gons (and a "cargroup" polygon the loader drops),
    the instance-id image (label id * 1000 + k over a road band of id 7)
    and the frame handed over in memory, their PNG files left empty (no image
    decoder on the card). Returns (frames by path, id images by path,
    instance count)."""
    rs = np.random.RandomState(seed)
    h, w = CITYSCAPES_HW
    frames_by_path, ids_by_path, count = {}, {}, 0
    img_dir = os.path.join(root, "cityscapes", "leftImg8bit", split, "smoke")
    ann_dir = os.path.join(root, "cityscapes", "gtFine", split, "smoke")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    angles = np.arange(16) * np.pi / 8
    for f in range(frames):
        base = "smoke_{:06d}_000019".format(f)
        img_path = os.path.join(img_dir, base + "_leftImg8bit.png")
        ids_path = os.path.join(ann_dir, base + "_gtFine_instanceIds.png")
        for path in (img_path, ids_path):
            open(path, "wb").close()
        frames_by_path[img_path] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ids = np.zeros((h, w), np.uint16)
        ids[h * 3 // 4:] = 7
        objects, per_class, boxes = [], {}, np.zeros((0, 4))
        for _ in range(rs.randint(20, 40)):
            while True:
                rx, ry = rs.uniform(12, 160), rs.uniform(12, 120)
                cx, cy = rs.uniform(rx, w - rx), rs.uniform(ry, h - ry)
                box = np.array([cx - rx, cy - ry, cx + rx, cy + ry])
                inter = np.prod(np.clip(np.minimum(boxes[:, 2:], box[2:])
                                        - np.maximum(boxes[:, :2], box[:2]), 0, None), axis=1)
                union = np.prod(box[2:] - box[:2]) + np.prod(boxes[:, 2:] - boxes[:, :2], 1)
                if (inter <= 0.3 * (union - inter)).all():
                    break
            boxes = np.vstack([boxes, box])
            cid = int(rs.choice(CITYSCAPES_IDS))
            per_class[cid] = per_class.get(cid, 0) + 1
            x0, x1, y0, y1 = int(cx - rx), int(cx + rx) + 1, int(cy - ry), int(cy + ry) + 1
            yy, xx = np.mgrid[y0:y1, x0:x1]
            inside = ((xx + 0.5 - cx) / rx) ** 2 + ((yy + 0.5 - cy) / ry) ** 2 <= 1
            ids[y0:y1, x0:x1][inside] = cid * 1000 + per_class[cid]
            poly = np.stack([cx + rx * np.cos(angles), cy + ry * np.sin(angles)], 1)
            objects.append({"label": CITYSCAPES_NAMES[cid], "polygon": poly.round(2).tolist()})
        count += len(objects)
        objects.append({"label": "cargroup", "polygon": [[0, 0], [9, 0], [9, 9]]})
        with open(os.path.join(ann_dir, base + "_gtFine_polygons.json"), "w") as fh:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, fh)
        ids_by_path[ids_path] = ids
    return frames_by_path, ids_by_path, count


def write_voc_annotations(root, ids, sizes, objects):
    """VOC2007's Annotations/<id>.xml (1-based pixel boxes) and its test
    image set; objects[i] is a list of (class name, x0, y0, x1, y1) in
    0-based pixels."""
    voc = os.path.join(root, "voc", "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, d), exist_ok=True)
    for img_id, (h, w), objs in zip(ids, sizes, objects):
        xml = "".join(
            "<object><name>{}</name><difficult>0</difficult><bndbox><xmin>{!r}</xmin>"
            "<ymin>{!r}</ymin><xmax>{!r}</xmax><ymax>{!r}</ymax></bndbox></object>".format(
                name, x0 + 1, y0 + 1, x1 + 1, y1 + 1) for name, x0, y0, x1, y1 in objs)
        with open(os.path.join(voc, "Annotations", img_id + ".xml"), "w") as f:
            f.write("<annotation><size><width>{}</width><height>{}</height><depth>3</depth>"
                    "</size>{}</annotation>".format(w, h, xml))
    with open(os.path.join(voc, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def synthetic_voc(np, root, n, seed):
    """A VOC2007 test split of n images of VOC's sizes from `seed`, 1-4
    boxes each of its 20 classes; the images are returned by id (handed over
    in memory), their JPEG files left empty."""
    from maskrcnn_tpu_torch.data.datasets import PascalVOCDataset

    rs = np.random.RandomState(seed)
    ids = ["{:06d}".format(i) for i in range(n)]
    sizes = [((375, 500), (500, 375), (333, 500))[i % 3] for i in range(n)]
    images, objects = {}, []
    for img_id, (h, w) in zip(ids, sizes):
        images[img_id] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        objs = []
        for _ in range(rs.randint(1, 5)):
            bw, bh = rs.randint(20, w // 2), rs.randint(20, h // 2)
            x0, y0 = rs.randint(0, w - bw), rs.randint(0, h - bh)
            objs.append((PascalVOCDataset.CLASSES[rs.randint(1, 21)], float(x0), float(y0),
                         float(x0 + bw - 1), float(y0 + bh - 1)))
        objects.append(objs)
    write_voc_annotations(root, ids, sizes, objects)
    for img_id in ids:
        open(os.path.join(root, "voc", "VOC2007", "JPEGImages", img_id + ".jpg"), "wb").close()
    return images, ids, sizes


def data_layer_phase(torch, np, card):
    """24-27. The published configs as written, through train_net and test_net
    in-process: pretrained weights from catalog:// names in a local cache,
    two concatenated COCO datasets, Cityscapes at 1024x2048 (polygons, then
    binary masks with ColorJitter on a concatenation) with its evaluator, and
    Pascal VOC with its evaluator. No phase may download: urllib's retrieve
    raises here. Returns the launches and wall seconds by phase and the
    kernel sites of phase 25."""
    import pickle
    import urllib.request

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config.paths_catalog import ModelCatalog
    from maskrcnn_tpu_torch.data.datasets import (
        CityScapesDataset,
        COCODataset,
        ConcatDataset,
        PascalVOCDataset,
    )
    from maskrcnn_tpu_torch.data.evaluation import evaluate
    from maskrcnn_tpu_torch.engine import trainer
    from maskrcnn_tpu_torch.models import build_detection_model, detector, layers, poolers, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.predictor import Predictor
    from maskrcnn_tpu_torch.structures import BoxList
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils.model_zoo import cached_name

    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    cache = os.path.join(work, "cache")
    patched = [(COCODataset, "_load_image"), (CityScapesDataset, "_load_image"),
               (CityScapesDataset, "_load_instance_ids"), (PascalVOCDataset, "_load_image"),
               (train_net, "do_train"), (urllib.request, "urlretrieve"),
               (trainer, "make_train_step")]
    saved = [getattr(obj, name) for obj, name in patched]
    logs = LogLines()
    loggers = [logging.getLogger(n) for n in ("maskrcnn_tpu_torch",
                                              "maskrcnn_tpu_torch.checkpointer")]
    for lg in loggers:
        lg.addHandler(logs)
        lg.setLevel(logging.INFO)
        lg.propagate = False
    # the group norms too: only phase 32's GN family may launch them
    counters = dict(training_counters(poolers, matcher, nms), **group_norm_counters(layers))
    record = {}
    launches, phase_s = {}, {}

    def refuse(url, *args, **kwargs):
        raise SmokeError("a phase tried to download {}".format(url))

    def recording(model, optimizer, scheduler, data_loader, *args, **kwargs):
        record["start"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        record["dataset"] = data_loader.dataset
        trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
        record["frozen"] = sorted(n for n, p in model.named_parameters() if id(p) not in trained)
        check(all(p.requires_grad == (id(p) in trained) for p in model.parameters()),
              "the optimizer's parameters are not the trainable ones")
        return saved[4](model, optimizer, scheduler, data_loader, *args, **kwargs)

    def recording_step(model, optimizer, *args, **kwargs):
        step = saved[6](model, optimizer, *args, **kwargs)

        record["step"] = step

        def run(batch, draws=None):
            record.setdefault("batch", batch)
            record.setdefault("solver", []).append(
                [(g["lr"], g["weight_decay"], g["momentum"]) for g in optimizer.param_groups])
            metrics = step(batch, draws)
            record.setdefault("losses", []).append({k: v.detach() for k, v in metrics.items()})
            return metrics
        return run

    def reset():
        logs.lines.clear()
        record.clear()
        for fn in counters.values():
            fn.launches = 0
        return time.perf_counter()

    def done(path, t0, per_step, steps, extra=None):
        """The launches of a phase's run: `steps` times per_step, plus extra."""
        torch.cuda.synchronize()
        phase_s[path] = time.perf_counter() - t0
        launches[path] = {k: fn.launches for k, fn in counters.items()}
        want = {k: steps * per_step.get(k, 0) + (extra or {}).get(k, 0) for k in counters}
        check(launches[path] == want, "{} launched {}, expected {}".format(
            path, launches[path], want))
        print("{}: launches {} in {:.1f} s [{}]".format(path, json.dumps(launches[path]),
                                                         phase_s[path], card), flush=True)

    def loaded_count():
        counts = [re.match(r"loaded (\d+)/(\d+) tensors", line) for line in logs.lines]
        counts = [(int(m[1]), int(m[2])) for m in counts if m]
        check(len(counts) == 1, "loader count lines: {}".format(counts))
        return counts[0]

    def train_summary(meters, config, opts=(), n_losses=5,
                      frozen_prefixes=("backbone.body.stem.", "backbone.body.layer1.")):
        """Each iteration's n_losses losses and their sum, every one finite, and the solver each
        iteration ran: both parameter groups at the rate of the config's
        schedule (linear warm-up from WARMUP_FACTOR, GAMMA at each of STEPS;
        biases at BIAS_LR_FACTOR x with WEIGHT_DECAY_BIAS), computed here
        from the config file, and only the stem and layer1 frozen
        (FREEZE_CONV_BODY_AT 2; frozen_prefixes (): nothing frozen, as an
        FBNet body)."""
        losses = [{k: v.item() for k, v in m.items()} for m in record.pop("losses")]
        check(all(len(it) == n_losses + 1 and all(math.isfinite(v) for v in it.values())
                  for it in losses), "losses {}".format(losses))
        c = defaults.clone()
        c.merge_from_file(config)
        c.merge_from_list(list(opts))
        s = c.SOLVER
        check(s.WARMUP_METHOD == "linear" and c.MODEL.BACKBONE.FREEZE_CONV_BODY_AT == 2,
              "{}: warm-up {}".format(config, s.WARMUP_METHOD))
        solver = record.pop("solver")
        check(len(solver) == len(losses), "{} solver states for {} iterations".format(
            len(solver), len(losses)))
        for k, groups in enumerate(solver):
            alpha = k / s.WARMUP_ITERS
            f = s.WARMUP_FACTOR * (1 - alpha) + alpha if k < s.WARMUP_ITERS else 1.0
            f *= s.GAMMA ** sum(k >= m for m in s.STEPS)
            want = [(s.BASE_LR * f, s.WEIGHT_DECAY, s.MOMENTUM),
                    (s.BASE_LR * s.BIAS_LR_FACTOR * f, s.WEIGHT_DECAY_BIAS, s.MOMENTUM)]
            check(len(groups) == 2 and all(
                math.isclose(g[0], w[0], rel_tol=1e-12) and g[1:] == w[1:]
                for g, w in zip(groups, want)),
                  "iteration {} ran the solver groups {}, the schedule says {}".format(
                      k, groups, want))
        frozen = record.pop("frozen")
        check(bool(frozen) == bool(frozen_prefixes)
              and all(n.startswith(frozen_prefixes) for n in frozen),
              "frozen parameters {}".format(frozen))
        waits, times = list(meters.meters["data"].deque), list(meters.meters["time"].deque)
        return {"losses_each": losses, "lr_each": [g[0][0] for g in solver],
                "frozen_parameters": len(frozen), "s_per_iter_each": times,
                "data_wait_s_each": waits, "data_wait_share": sum(waits) / sum(times)}

    @contextlib.contextmanager
    def first_step(pooled=2):
        """The kernels' inputs in the first training step of a run (and the
        gradients that reach the pooled outputs): `pooled` ROIAlign calls a
        step (box and mask heads, or the box head alone)."""
        caps = {"matcher": Capture([rpn], "match_anchors_batched", limit=1),
                "nms": Capture([rpn], "batched_nms", limit=1),
                "roi_align": Capture([detector], "multilevel_roi_align", grads=True,
                                     limit=pooled)}
        with contextlib.ExitStack() as stack:
            for c in caps.values():
                stack.enter_context(c)
            yield caps

    def step_sites(path, caps, images, lanes, pooled=2):
        """Each kernel of a run's first step against its plain version on
        that step's inputs, timed beside its bound; the inputs are let go."""
        m, n, r = caps["matcher"], caps["nms"], caps["roi_align"]
        check(len(m.calls) == 1 and len(n.calls) == 1 and len(r.calls) == pooled
              and len(r.out_grads) == pooled, "{}: captured {} matcher, {} NMS, {} ROIAlign calls"
              .format(path, len(m.calls), len(n.calls), len(r.calls)))
        host = {"loadavg_1min": os.getloadavg()[0], "threads": threading.active_count(),
                "child_processes": len(multiprocessing.active_children())}
        sites = {"matcher": [matcher_site(torch, matcher, *m.calls[0], timeline=True)]}
        with torch.no_grad():
            sites["nms"] = [nms_site(torch, nms, *n.calls[0], plain_iters=3)]
            sites["roi_align"] = [roi_site(torch, poolers, [f.detach() for f in call[0]],
                                           *call[1:]) for call in r.calls]
        sites["roi_align_backward"] = [
            roi_backward_site(torch, poolers, [f.detach() for f in call[0]], *call[1:],
                              r.out_grads[i], "roi") for i, call in enumerate(r.calls)]
        p2 = list(r.calls[0][0][0].shape)
        for c in caps.values():
            c.calls.clear()
            c.out_grads.clear()
        torch.cuda.empty_cache()
        check(p2[0] == images and sites["matcher"][0]["images"] == images
              and sites["nms"][0]["shape"] == list(lanes),
              "{}: P2 {}, matcher {}, NMS lanes {}".format(
                  path, p2, sites["matcher"][0]["images"], sites["nms"][0]["shape"]))
        print("{}: the host while the kernels were timed: {}".format(path, json.dumps(host)),
              flush=True)
        for name, ss in sites.items():
            for s_ in ss:
                print("{} kernel site {} (P2 {}) [{}]: {}".format(
                    path, name, p2, card, json.dumps(s_)), flush=True)
        return sites, p2

    step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2}
    urllib.request.urlretrieve = refuse
    train_net.do_train = recording
    trainer.make_train_step = recording_step
    try:
        with environ(MASKRCNN_TPU_DATA_DIR=work, MASKRCNN_TPU_CACHE=cache):
            # 24. the flagship's published recipe
            t0 = reset()
            flagship = os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
            coco = {}
            coco["train2014"], n_a, _ = synthetic_coco(np, work, "train2014", ((480, 640),) * 24,
                                                       seed=SEED + 10)
            coco["val2014"], n_b, _ = synthetic_coco(
                np, work, "val2014", ((480, 640),) * 16, seed=SEED + 11,
                ann="instances_valminusminival2014.json")
            COCODataset._load_image = (
                lambda self, index: coco[os.path.basename(self.root)][self.ids[index]])
            cfg = defaults.clone()
            cfg.merge_from_file(flagship)
            check(cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50"
                  and cfg.DATASETS.TRAIN == ("coco_2014_train", "coco_2014_valminusminival"),
                  "the flagship's YAML reads {} on {}".format(cfg.MODEL.WEIGHT,
                                                              cfg.DATASETS.TRAIN))
            first = torch.from_numpy(np.stack([coco["train2014"][i] for i in range(1, 9)])).cuda()
            sizes = torch.tensor([[480, 640]] * 8, dtype=torch.int32, device="cuda")
            model = build_detection_model(cfg, device="cuda", seed=SEED + 4)
            calibrate_frozen_bn(torch, model, model._prepare_images(first, sizes),
                                residual_scale=R50_RESIDUAL_SCALE)
            body = {k: v.cpu().numpy() for k, v in model.state_dict().items()
                    if k.startswith("backbone.body.")}
            del model
            r50 = os.path.join(cache, cached_name(ModelCatalog.get("ImageNetPretrained/MSRA/R-50")))
            r50_blobs = detectron_blobs(np, body, imagenet=True, seed=SEED)
            write_pkl(r50, r50_blobs, wrap=False)
            print("flagship recipe: synthetic COCO trees coco_2014_train ({} images of 480x640, "
                  "{} instances) and coco_2014_valminusminival ({}, {}); the cache holds a "
                  "synthetic R-50.pkl ({} Detectron blobs, {:.1f} MB: the seeded body with "
                  "frozen-BN affine pairs from 8 of the images, each block's last BN and its "
                  "shortcut's at weight {}, an fc1000, _momentum blobs); "
                  "train_net --config-file configs/e2e_mask_rcnn_R_50_FPN_1x.yaml --skip-test "
                  "SOLVER.MAX_ITER 4 OUTPUT_DIR <dir> (SOLVER.IMS_PER_BATCH 16 as written)"
                  .format(len(coco["train2014"]), n_a, len(coco["val2014"]), n_b, len(r50_blobs),
                          os.path.getsize(r50) / 1e6, R50_RESIDUAL_SCALE), flush=True)
            out = os.path.join(work, "flagship")
            with first_step() as caps:
                _, meters = train_net.main(["--config-file", flagship, "--skip-test",
                                            "SOLVER.MAX_ITER", "4", "OUTPUT_DIR", out])
                done("flagship_recipe", t0, step, 4)
            sites = {}
            dataset = record["dataset"]
            check(isinstance(dataset, ConcatDataset) and len(dataset.datasets) == 2
                  and len(dataset) == len(coco["train2014"]) + len(coco["val2014"]),
                  "the training dataset is {} of {} images".format(type(dataset).__name__,
                                                                   len(dataset)))
            expected = imagenet_expected(np, body)
            start = record["start"]
            check(all(torch.equal(start[k].cpu(), torch.from_numpy(v))
                      for k, v in expected.items()),
                  "the body's tensors differ from the R-50.pkl blobs")
            fresh = build_detection_model(cfg, device="cuda").state_dict()
            heads = [k for k in start if not k.startswith("backbone.body.")]
            check(all(torch.equal(start[k], fresh[k]) for k in heads),
                  "a head's tensor moved from its init")
            n_loaded, n_total = loaded_count()
            n_stats = sum(k.endswith(("running_mean", "running_var")) for k in body)
            check(n_loaded == len(body) - n_stats, "R-50.pkl loaded {} tensors".format(n_loaded))
            summary = train_summary(meters, flagship)
            print("flagship recipe: the concatenated dataset has {} images; loaded {}/{} tensors "
                  "from R-50.pkl, every one of the body's {} convs and BN affine pairs equal to "
                  "its blob bit for bit (its {} running statistics at 0 and 1); the {} tensors "
                  "of the FPN and heads at their init; 4 iterations at batch 16: {} [{}]".format(
                      len(dataset), n_loaded, n_total, n_loaded, n_stats, len(heads),
                      json.dumps(summary), card), flush=True)
            del start, fresh
            record.clear()
            sites["flagship_recipe"], _ = step_sites("flagship recipe", caps, 16, (80, 2000))

            # a whole Detectron model_final served from its catalog:// name
            t0 = reset()
            seeded = build_detection_model(cfg, device="cuda", seed=SEED + 5)
            calibrate_frozen_bn(torch, seeded, seeded._prepare_images(first, sizes))
            fold_frozen_bn(torch, seeded)
            state = {k: v.cpu().numpy() for k, v in seeded.state_dict().items()}
            baseline = "Caffe2Detectron/COCO/35858933/e2e_mask_rcnn_R-50-FPN_1x"
            other = "Caffe2Detectron/COCO/35861795/e2e_mask_rcnn_R-101-FPN_1x"
            final = os.path.join(cache, cached_name(ModelCatalog.get(baseline)))
            blobs = detectron_blobs(np, state)
            write_pkl(final, blobs, wrap=True)
            other_file = cached_name(ModelCatalog.get(other))
            check(other_file != os.path.basename(final)
                  and not os.path.exists(os.path.join(cache, other_file)),
                  "two Detectron baselines share the cache file {}".format(other_file))
            scfg = cfg.clone()
            scfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
            scfg.OUTPUT_DIR = os.path.join(work, "serve")
            ref = Predictor(scfg, model=seeded, min_image_size=scfg.INPUT.MIN_SIZE_TEST)
            scfg.MODEL.WEIGHT = "catalog://" + baseline
            served = Predictor(scfg, device="cuda", seed=SEED,
                               min_image_size=scfg.INPUT.MIN_SIZE_TEST)
            own, theirs = served.model.state_dict(), seeded.state_dict()
            check(set(own) == set(theirs) and all(torch.equal(own[k], v)
                                                  for k, v in theirs.items()),
                  "the served model's tensors differ from the seeded model's")
            n_loaded, n_total = loaded_count()
            n_stats = sum(k.endswith(("running_mean", "running_var")) for k in state)
            check(n_loaded == n_total - n_stats, "model_final loaded {}/{} tensors".format(
                n_loaded, n_total))
            rs = np.random.RandomState(SEED + 6)
            dets = []
            for h, w in ((480, 640), (640, 480)):
                img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                a, b = served.compute_prediction(img), ref.compute_prediction(img)
                check(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a),
                      "the served detections differ from the seeded model's")
                dets.append(len(a["scores"]))
            done("detectron_model_final", t0, {"nms": 2, "roi_align": 2}, 4)
            print("detectron model_final: {} Detectron blobs ({:.1f} MB) under {} in the cache "
                  "({} for the R-101-FPN baseline); Predictor from {}: loaded {}/{} tensors, "
                  "the {} kept at init the frozen BN's running statistics (no such blob; 0 and 1 "
                  "in both), all {} equal to the seeded model's bit for bit; {} detections on "
                  "480x640 and 640x480 equal to the seeded model's".format(
                      len(blobs), os.path.getsize(final) / 1e6, os.path.basename(final),
                      other_file, scfg.MODEL.WEIGHT, n_loaded, n_total, n_stats, n_total, dets),
                  flush=True)
            del seeded, served, ref, own, theirs, first
            torch.cuda.empty_cache()

            # 25. Cityscapes at its own scale: polygons, 1024x2048
            t0 = reset()
            frames, id_images, n_inst = {}, {}, {}
            for split, count, seed in (("train", CITYSCAPES_FRAMES[0], SEED + 20),
                                       ("val", CITYSCAPES_FRAMES[1], SEED + 21)):
                f, i, n_inst[split] = synthetic_cityscapes(np, work, split, count, seed)
                frames.update(f)
                id_images.update(i)
            CityScapesDataset._load_image = lambda self, idx: frames[self.img_paths[idx]]
            CityScapesDataset._load_instance_ids = (
                lambda self, idx: id_images[self.ann_paths[idx]])
            poly = os.path.join(REPO, "configs", "cityscapes",
                                "e2e_mask_rcnn_R_50_FPN_1x_poly.yaml")
            print("cityscapes: synthetic gtFine trees of {} train and {} val frames of 2048x1024 "
                  "({} and {} instances); train_net --config-file "
                  "configs/cityscapes/e2e_mask_rcnn_R_50_FPN_1x_poly.yaml --skip-test "
                  "SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (batch 8, short side 800-1024, long side "
                  "2048, its catalog:// R-50 from the cache), then test_net with the same config "
                  "on cityscapes_poly_instance_val (its MODEL.WEIGHT: the R-50 body and the "
                  "seeded heads)"
                  .format(*CITYSCAPES_FRAMES, n_inst["train"], n_inst["val"]), flush=True)
            torch.cuda.reset_peak_memory_stats()
            with first_step() as caps:
                _, meters = train_net.main(["--config-file", poly, "--skip-test",
                                            "SOLVER.MAX_ITER", "3", "OUTPUT_DIR",
                                            os.path.join(work, "cityscapes_poly")])
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            test_net.main(["--config-file", poly, "OUTPUT_DIR",
                           os.path.join(work, "cityscapes_poly_test")])
            test_batches = -(-CITYSCAPES_FRAMES[1] // 8)
            done("cityscapes", t0, step, 3, {"nms": 2 * test_batches,
                                            "roi_align": 2 * test_batches})
            dataset = record["dataset"]
            check(isinstance(dataset, CityScapesDataset) and dataset.mode == "poly"
                  and len(dataset) == CITYSCAPES_FRAMES[0], "cityscapes dataset {}".format(dataset))
            summary = train_summary(meters, poly)
            tables = [line for line in logs.lines if line.startswith("Cityscapes ")]
            check(len(tables) == 2, "the Cityscapes evaluator logged {} tables".format(len(tables)))
            for line in tables:
                print("  " + line.replace("\n", "\n  "), flush=True)
            # a known answer for the evaluator at the frames' size: the val
            # tree's own instances as detections (each mask cropped to its box
            # at 28x28) must give AP50 1.0 for boxes and masks
            t1 = time.perf_counter()
            val = CityScapesDataset(os.path.join(work, "cityscapes", "leftImg8bit"),
                                    os.path.join(work, "cityscapes", "gtFine"), "val", "poly")
            preds = []
            for idx in range(len(val)):
                target = val[idx][1]
                n = len(target)
                masks = target.get_field("masks")
                probs = np.stack([np.asarray(masks[j].crop(target.bbox[j]).resize((28, 28))
                                             .get_mask_tensor(), np.float32).reshape(28, 28)
                                  for j in range(n)])
                p = BoxList(target.bbox.copy(), target.size, "xyxy")
                p.add_field("labels", np.asarray(target.get_field("labels")))
                p.add_field("scores", np.linspace(0.95, 0.6, n).astype(np.float32))
                p.add_field("mask", probs[:, None])
                preds.append(p)
            known = evaluate(val, preds, None, iou_types=("bbox", "segm"))
            known = {k: known[k]["allAp50%"] for k in ("bbox", "segm")}
            print("cityscapes known answer (the val instances as detections, {} frames of "
                  "2048x1024) in {:.1f} s: allAp50% {}".format(
                      len(val), time.perf_counter() - t1, json.dumps(known)), flush=True)
            check(min(known.values()) >= 0.99, "Cityscapes known answer {}".format(known))
            print("cityscapes: 3 iterations: {}; peak memory {:.3f} GB (the first step's kernel "
                  "inputs kept) [{}]".format(json.dumps(summary), peak_gb, card), flush=True)
            sites["cityscapes"], p2 = step_sites("cityscapes", caps, 8, (40, 2000))
            check(p2[:3] == [8, 256, 512] and sites["cityscapes"]["matcher"][0]["anchors"]
                  == 523776, "cityscapes P2 {}, matcher {}".format(
                      p2, sites["cityscapes"]["matcher"][0]))

            # 26. binary masks on a concatenation, with ColorJitter
            t0 = reset()
            binary = os.path.join(REPO, "configs", "cityscapes",
                                  "e2e_mask_rcnn_R_50_FPN_1x_binarymask.yaml")
            opts = ["DATASETS.TRAIN", "('cityscapes_mask_instance_train', "
                    "'cityscapes_mask_instance_val')", "INPUT.BRIGHTNESS", "0.2",
                    "INPUT.CONTRAST", "0.2", "INPUT.SATURATION", "0.2", "INPUT.HUE", "0.05"]
            print("binary masks: train_net --config-file "
                  "configs/cityscapes/e2e_mask_rcnn_R_50_FPN_1x_binarymask.yaml --skip-test {} "
                  "SOLVER.MAX_ITER 2 OUTPUT_DIR <dir> (SOLVER.IMS_PER_BATCH 16 and the default "
                  "800x1333 as written; the instance-id images handed over in memory)".format(
                      " ".join(opts)), flush=True)
            with first_step() as caps:
                _, meters = train_net.main(["--config-file", binary, "--skip-test"] + opts + [
                    "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", os.path.join(work, "cityscapes_mask")])
                done("binary_masks", t0, step, 2)
            dataset = record["dataset"]
            check(isinstance(dataset, ConcatDataset)
                  and [d.mode for d in dataset.datasets] == ["mask", "mask"]
                  and len(dataset) == sum(CITYSCAPES_FRAMES), "binary-mask dataset {}".format(
                      dataset))
            jitter = dataset.datasets[0].transforms.transforms[0]
            check(type(jitter).__name__ == "ColorJitter"
                  and (jitter.brightness, jitter.contrast, jitter.saturation, jitter.hue)
                  == (0.2, 0.2, 0.2, 0.05), "the pipeline starts with {}".format(jitter))
            summary = train_summary(meters, binary, opts)
            print("binary masks: a concatenation of {} mask-mode frames, ColorJitter first; "
                  "2 iterations at batch 16, the loader's wait: {} [{}]".format(
                      len(dataset), json.dumps(summary), card), flush=True)
            record.clear()
            sites["binary_masks"], _ = step_sites("binary masks", caps, 16, (80, 2000))

            # 27. Pascal VOC, then its known answer
            t0 = reset()
            voc_images, voc_ids, voc_sizes = synthetic_voc(np, work, VOC_IMAGES, SEED + 30)
            PascalVOCDataset._load_image = lambda self, index: voc_images[self.ids[index]]
            faster = os.path.join(REPO, "configs", "e2e_faster_rcnn_R_50_FPN_1x.yaml")
            opts = ["MODEL.ROI_BOX_HEAD.NUM_CLASSES", "21", "MODEL.ROI_HEADS.SCORE_THRESH",
                    "0.0", "DATASETS.TEST", "('voc_2007_test',)"]
            print("voc: a synthetic VOC2007 test split of {} images (375x500, 500x375, "
                  "333x500); test_net --config-file configs/e2e_faster_rcnn_R_50_FPN_1x.yaml {} "
                  "OUTPUT_DIR <dir> (its catalog:// R-50 from the cache; SCORE_THRESH 0 for "
                  "random heads)".format(VOC_IMAGES, " ".join(opts)), flush=True)
            out = os.path.join(work, "voc")
            (first_pass,) = test_net.main(["--config-file", faster] + opts + ["OUTPUT_DIR", out])
            done("voc", t0, {"nms": 2, "roi_align": 1}, -(-VOC_IMAGES // 8))
            with open(os.path.join(out, "inference", "voc_2007_test", "predictions.pkl"),
                      "rb") as f:
                preds = pickle.load(f)
            check(len(preds) == VOC_IMAGES, "{} VOC predictions".format(len(preds)))
            gt = [[(PascalVOCDataset.CLASSES[int(label)], *map(float, box))
                   for box, label in zip(p.bbox, p.get_field("labels"))] for p in preds]
            write_voc_annotations(work, voc_ids, voc_sizes, gt)
            out2 = os.path.join(work, "voc2")
            (second,) = test_net.main(["--config-file", faster] + opts + ["OUTPUT_DIR", out2])
            known = {"map_first_pass": float(first_pass["map"]), "gt_from_detections":
                     sum(len(g) for g in gt), "map_known_answer": float(second["map"])}
            print("voc known answer (the first pass's detections as gt) [{}]: {}".format(
                card, json.dumps(known)), flush=True)
            check(second["map"] >= 0.99, "VOC known-answer mAP {} < 0.99".format(second["map"]))
            phase_s["voc"] = time.perf_counter() - t0

            # 28-30. RetinaNet and Faster R-CNN R-101-FPN on this phase's trees and cache
            t0 = time.perf_counter()
            sites.update(families_phase(torch, np, card, types.SimpleNamespace(
                work=work, cache=cache, coco=coco, record=record, reset=reset, done=done,
                loaded_count=loaded_count, train_summary=train_summary, first_step=first_step,
                step_sites=step_sites)))
            phase_s["families"] = time.perf_counter() - t0

            # 31. Keypoint R-CNN on this phase's images and cache
            t0 = time.perf_counter()
            sites.update(keypoint_phase(torch, np, card, types.SimpleNamespace(
                work=work, coco=coco, record=record, reset=reset, done=done,
                loaded_count=loaded_count, train_summary=train_summary, first_step=first_step,
                step_sites=step_sites)))
            phase_s["keypoints"] = time.perf_counter() - t0

            # 32-33. The GN and C4 families on this phase's trees and cache
            gc_sites, gc_s = gn_c4_phase(torch, np, card, types.SimpleNamespace(
                work=work, cache=cache, coco=coco, record=record, reset=reset, done=done,
                loaded_count=loaded_count, train_summary=train_summary, first_step=first_step,
                step_sites=step_sites))
            sites.update(gc_sites)
            phase_s.update(gc_s)

            # 34-36. RPN-only, deformable convs and FBNet on this phase's trees and cache
            lf_sites, lf_s = last_families_phase(torch, np, card, types.SimpleNamespace(
                work=work, cache=cache, coco=coco, record=record, reset=reset, done=done,
                loaded_count=loaded_count, train_summary=train_summary, first_step=first_step,
                step_sites=step_sites))
            sites.update(lf_sites)
            phase_s.update(lf_s)

            # 37-40. TTA, the demo, eval_zoo and polygons on this phase's trees and cache
            td_sites, td_s = tta_demo_phase(torch, np, card, types.SimpleNamespace(
                work=work, cache=cache, coco=coco, reset=reset, done=done, logs=logs,
                launches=launches))
            sites.update(td_sites)
            phase_s.update(td_s)
        return {"launches": launches, "phase_s": phase_s, "sites": sites}
    finally:
        for (obj, name), value in zip(patched, saved):
            setattr(obj, name, value)
        for lg in loggers:
            lg.removeHandler(logs)
        shutil.rmtree(work, ignore_errors=True)


def detections_as_gt(preds, infos):
    """COCO annotations of a test pass's detections (BoxLists on the
    original images, in the order of `infos`), boxes with the +1 convention;
    the synthetic trees' JSON category ids are the contiguous labels."""
    anns = []
    for info, p in zip(infos, preds):
        for box, label in zip(p.bbox, p.get_field("labels")):
            x0, y0, x1, y1 = (float(v) for v in box)
            anns.append({"id": len(anns) + 1, "image_id": info["id"], "iscrowd": 0,
                         "category_id": int(label), "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                         "area": (x1 - x0 + 1) * (y1 - y0 + 1),
                         "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]]})
    return anns


def families_phase(torch, np, card, dl):
    """28-30. RetinaNet (serving, train_net, test_net with a known answer) and
    Faster R-CNN R-101-FPN (train_net, test_net), each from its published
    config as written, on phase 24's COCO trees and weight cache (dl: the
    data-layer phases' work tree, cache, trees and helpers). Returns the
    kernel sites by path."""
    import pickle

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config.paths_catalog import ModelCatalog
    from maskrcnn_tpu_torch.models import build_detection_model, detector, retinanet
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.predictor import Predictor
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils.model_zoo import cached_name
    from maskrcnn_tpu_torch.utils import profiling

    def path_sites(**found):
        return {k: found.get(k, []) for k in ("nms", "roi_align", "roi_align_backward", "matcher")}

    retina_yaml = os.path.join(REPO, "configs", "retinanet", "retinanet_R-50-FPN_1x.yaml")
    faster_yaml = os.path.join(REPO, "configs", "e2e_faster_rcnn_R_101_FPN_1x.yaml")
    ann_dir = os.path.join(dl.work, "coco", "annotations")
    with open(os.path.join(ann_dir, "instances_valminusminival2014.json")) as f:
        val = json.load(f)
    minival = os.path.join(ann_dir, "instances_minival2014.json")
    sites = {}

    # 28. serving RetinaNet from the cache's R-50.pkl
    dl.reset()
    cfg = defaults.clone()
    cfg.merge_from_file(retina_yaml)
    check(cfg.MODEL.RETINANET_ON and cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50"
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the RetinaNet YAML reads {}".format(
              cfg.MODEL.WEIGHT))
    # random heads: the prior puts every score near 0.01, below INFERENCE_TH
    cfg.MODEL.RETINANET.INFERENCE_TH = 0.0
    rs = np.random.RandomState(SEED + 8)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUEST_SIZES]
    pred = Predictor(cfg, device="cuda", seed=SEED + 7, min_image_size=cfg.INPUT.MIN_SIZE_TEST)
    n_loaded, n_total = dl.loaded_count()
    pred.compute_prediction(warm)
    t0 = dl.reset()
    outs, latencies = [], []
    with Capture([retinanet], "batched_nms", limit=1) as nms_cap:
        for img in images:
            t1 = time.perf_counter()
            outs.append(pred.compute_prediction(img))
            latencies.append((time.perf_counter() - t1) * 1e3)
        dl.done("retinanet_serving", t0, {"nms": 1}, len(images))
    for img, out in zip(images, outs):
        n = len(out["scores"])
        h, w = img.shape[:2]
        check(set(out) == {"boxes", "scores", "labels"}
              and 0 < n <= cfg.TEST.DETECTIONS_PER_IMG and out["boxes"].shape == (n, 4)
              and np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()
              and ((out["labels"] >= 1) & (out["labels"] <= 80)).all()
              and (out["boxes"][:, [0, 2]] <= w * 1.001).all()
              and (out["boxes"][:, [1, 3]] <= h * 1.001).all(),
              "RetinaNet request {}x{}: {}".format(h, w, {k: v.shape for k, v in out.items()}))
    lane = nms_cap.calls[0]
    with torch.inference_mode():
        site = nms_site(torch, nms, *lane, plain_iters=3)
    site["max_coordinate"] = float(lane[0].max())
    check(site["shape"] == [1, 1000] and lane[3] == cfg.MODEL.RETINANET.NMS_TH,
          "RetinaNet NMS lane {} at {}".format(site["shape"], lane[3]))
    sites["retinanet_serving"] = path_sites(nms=[site])
    print("retinanet serving kernel site (one class-offset lane a request) [{}]: {}".format(
        card, json.dumps(site)), flush=True)
    # float32 card against CPU on a small image, the head redrawn so that the
    # scores spread: towers at He scale, the cls logits at 10 / sqrt(fan in)
    state = {k: v.detach().cpu().clone() for k, v in pred.model.state_dict().items()}
    gen = torch.Generator().manual_seed(SEED + 9)
    for k, v in state.items():
        if k.startswith("rpn.") and k.endswith(".weight"):
            gain = 10.0 if "cls_logits" in k else 2 ** 0.5 if "tower" in k else 1.0
            v.copy_(torch.randn(v.shape, generator=gen) * gain / v[0].numel() ** 0.5)
    ref = reference_check(torch, np, detector, cfg, state)
    print("retinanet float32 card vs CPU on a 256x320 image: " + json.dumps(ref), flush=True)
    check(ref["agree"] >= 0.9, "RetinaNet: card and CPU disagree on {:.1%} of detections"
          .format(1 - ref["agree"]))
    print("retinanet serving: configs/retinanet/retinanet_R-50-FPN_1x.yaml (bf16, "
          "INFERENCE_TH 0 for random heads) from the cache's R-50.pkl (loaded {}/{} tensors); "
          "latency ms per request {} {} [{}]".format(
              n_loaded, n_total, json.dumps(REQUEST_SIZES), json.dumps(latencies), card),
          flush=True)
    del pred, outs, nms_cap, lane
    torch.cuda.empty_cache()

    # 29. RetinaNet trained and tested as written
    t0 = dl.reset()
    out = os.path.join(dl.work, "retinanet")
    print("retinanet recipe: train_net --config-file configs/retinanet/retinanet_R-50-FPN_1x.yaml "
          "--skip-test SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (batch 16 on phase 24's trees, its "
          "catalog:// R-50 from the cache)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    caps = {"matcher": Capture([retinanet], "match_anchors_batched", limit=1),
            "focal": Capture([retinanet], "sigmoid_focal_loss", limit=1),
            "head": Capture([retinanet.RetinaNetHead], "forward", limit=1)}
    with contextlib.ExitStack() as stack:
        for c in caps.values():
            stack.enter_context(c)
        _, meters = train_net.main(["--config-file", retina_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        dl.done("retinanet_recipe", t0, {"matcher": 1}, 3)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    n_loaded, n_total = dl.loaded_count()
    summary = dl.train_summary(meters, retina_yaml, n_losses=2)
    check(len(dl.record["dataset"]) == len(dl.coco["train2014"]) + len(dl.coco["val2014"]),
          "the RetinaNet training dataset has {} images".format(len(dl.record["dataset"])))
    m = caps["matcher"].calls[0]
    check(tuple(m[1].shape[:2]) == (16, cfg.TPU.MAX_GT_BOXES) and m[0].shape[0] == 201600
          and (m[3], m[4]) == (0.5, 0.4), "RetinaNet matcher on {} anchors, gt {}, at {}".format(
              m[0].shape[0], tuple(m[1].shape), m[3:]))
    msite = matcher_site(torch, matcher, *m)
    # where the step's device time goes: the head (towers and predictors)
    # forward and backward on the first step's pyramid, the focal loss
    # forward and backward on its logits, the matcher
    head, feats = caps["head"].calls[0][0], [f.detach() for f in caps["head"].calls[0][1]]
    logits, labels, gamma, alpha = caps["focal"].calls[0]
    logits = logits.detach()
    leaves = [f.requires_grad_() for f in feats]
    ones = None

    def head_step():
        nonlocal ones
        outputs = [o for level in head(leaves) for o in level]
        ones = ones or [torch.ones_like(o) for o in outputs]
        torch.autograd.backward(outputs, ones)

    x = logits.requires_grad_()

    def focal_step():
        retinanet.sigmoid_focal_loss(x, labels, gamma, alpha).sum().backward()

    split = {"head_ms": profiling.device_busy_ms(head_step),
             "head_events_ms": cuda_ms(torch, head_step, 3, warmup=1),
             "focal_loss_ms": profiling.device_busy_ms(focal_step),
             "focal_loss_events_ms": cuda_ms(torch, focal_step, 3, warmup=1),
             "matcher_ms": msite["kernel_ms"], "focal_elements": logits.numel(),
             "pyramid": [list(f.shape) for f in feats]}
    del caps, m, head, feats, leaves, ones, logits, labels, x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = profiling.profile_steps(dl.record["step"], dl.record["batch"], steps=1)
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    if isinstance(prof.get("device_busy_ms"), float):
        known = [split[k] for k in ("head_ms", "focal_loss_ms", "matcher_ms")]
        if all(isinstance(v, float) for v in known):
            split["rest_ms"] = prof["device_busy_ms"] - sum(known)
    split.update(step_wall_ms=prof["wall_ms"], step_device_busy_ms=prof.get("device_busy_ms"),
                 idle_share=prof.get("idle_share"), top_kernels_ms=prof.get("top_kernels_ms"))
    print("retinanet recipe: loaded {}/{} tensors from R-50.pkl; 3 iterations at batch 16: {}; "
          "peak memory {:.3f} GB a step ({:.3f} GB over the run, the first step's inputs "
          "kept) [{}]".format(n_loaded, n_total, json.dumps(summary), peak_step_gb, peak_run_gb,
                              card), flush=True)
    print("retinanet step's device time, torch.profiler [{}]: {}".format(card, json.dumps(split)),
          flush=True)
    print("retinanet recipe matcher site (201,600 anchors an image, 0.5 / 0.4) [{}]: {}".format(
        card, json.dumps(msite)), flush=True)
    dl.record.clear()

    # test_net on coco_2014_minival (the YAML's: the 16 val2014 images), bbox
    # only, then the known answer: the first pass's detections as its gt
    with open(minival, "w") as f:
        json.dump(val, f)
    test_opts = ["--config-file", retina_yaml, "--ckpt", os.path.join(out, "model_final.pth"),
                 "MODEL.RETINANET.INFERENCE_TH", "0.0"]
    t0 = dl.reset()
    with Capture([retinanet], "batched_nms") as nms_cap:
        ((res, _),) = test_net.main(test_opts + ["OUTPUT_DIR", os.path.join(out, "test")])
        dl.done("retinanet_test", t0, {"nms": 1}, 2)
    check(set(res.results) == {"bbox"}, "RetinaNet evaluated {}".format(set(res.results)))
    with torch.inference_mode():
        lanes = [nms_site(torch, nms, *call, plain_iters=3) for call in nms_cap.calls]
    check([s_["shape"] for s_ in lanes] == [[8, 1000]] * 2, "RetinaNet test NMS lanes {}".format(
        [s_["shape"] for s_ in lanes]))
    for call, s_ in zip(nms_cap.calls, lanes):
        s_["max_coordinate"] = float(call[0].max())
        print("retinanet test kernel site [{}]: {}".format(card, json.dumps(s_)), flush=True)
    sites["retinanet_recipe"] = path_sites(matcher=[msite], nms=lanes)
    del nms_cap
    with open(os.path.join(out, "test", "inference", "coco_2014_minival", "predictions.pkl"),
              "rb") as f:
        preds = pickle.load(f)
    gts = detections_as_gt(preds, val["images"])
    write_coco_json(minival, val["images"], gts, range(1, 81))
    ((known, _),) = test_net.main(test_opts + ["OUTPUT_DIR", os.path.join(out, "test2")])
    known = {"bbox_first_pass": dict(res.results["bbox"]), "gt_from_detections": len(gts),
             "bbox_known_answer": dict(known.results["bbox"])}
    print("retinanet test_net on 16 images at TEST.IMS_PER_BATCH 8, then its known answer "
          "[{}]: {}".format(card, json.dumps(known)), flush=True)
    check(known["bbox_known_answer"]["AP50"] >= 0.99, "RetinaNet known-answer AP50 {}".format(
        known["bbox_known_answer"]["AP50"]))

    # 30. Faster R-CNN R-101-FPN as written, from a synthetic R-101.pkl
    t0 = dl.reset()
    cfg = defaults.clone()
    cfg.merge_from_file(faster_yaml)
    check(cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-101" and not cfg.MODEL.MASK_ON
          and cfg.MODEL.BACKBONE.CONV_BODY == "R-101-FPN", "the R-101 YAML reads {}".format(
              cfg.MODEL.WEIGHT))
    first = torch.from_numpy(np.stack([dl.coco["train2014"][i] for i in range(1, 9)])).cuda()
    sizes = torch.tensor([[480, 640]] * 8, dtype=torch.int32, device="cuda")
    model = build_detection_model(cfg, device="cuda", seed=SEED + 12)
    calibrate_frozen_bn(torch, model, model._prepare_images(first, sizes),
                        residual_scale=R50_RESIDUAL_SCALE)
    body = {k: v.cpu().numpy() for k, v in model.state_dict().items()
            if k.startswith("backbone.body.")}
    del model, first
    r101 = os.path.join(dl.cache, cached_name(ModelCatalog.get("ImageNetPretrained/MSRA/R-101")))
    write_pkl(r101, detectron_blobs(np, body, imagenet=True, seed=SEED), wrap=False)
    out = os.path.join(dl.work, "faster_r101")
    print("faster R-101: train_net --config-file configs/e2e_faster_rcnn_R_101_FPN_1x.yaml "
          "--skip-test SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (batch 16; a synthetic R-101.pkl of "
          "{:.1f} MB in the cache, built as phase 24's R-50.pkl)".format(
              os.path.getsize(r101) / 1e6), flush=True)
    step = {"matcher": 1, "nms": 1, "roi_align": 1, "roi_align_backward": 1}
    with dl.first_step(pooled=1) as caps:
        _, meters = train_net.main(["--config-file", faster_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        dl.done("faster_r101_recipe", t0, step, 3)
    expected = imagenet_expected(np, body)
    start = dl.record["start"]
    check(all(torch.equal(start[k].cpu(), torch.from_numpy(v)) for k, v in expected.items()),
          "the R-101 body's tensors differ from the R-101.pkl blobs")
    n_loaded, n_total = dl.loaded_count()
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in body)
    check(n_loaded == len(body) - n_stats, "R-101.pkl loaded {} tensors".format(n_loaded))
    summary = dl.train_summary(meters, faster_yaml, n_losses=4)
    print("faster R-101: loaded {}/{} tensors from R-101.pkl, the body's equal to its blobs; 3 "
          "iterations at batch 16: {} [{}]".format(n_loaded, n_total, json.dumps(summary), card),
          flush=True)
    dl.record.clear()
    sites["faster_r101_recipe"], _ = dl.step_sites("faster R-101", caps, 16, (80, 2000), pooled=1)
    del caps, start
    torch.cuda.empty_cache()
    # test_net on 8 of the val2014 images
    eight = {"images": val["images"][:8],
             "annotations": [a for a in val["annotations"] if a["image_id"] <= 8]}
    check([i["id"] for i in eight["images"]] == list(range(1, 9)), "val image ids")
    write_coco_json(minival, eight["images"], eight["annotations"], range(1, 81))
    t0 = dl.reset()
    ((res, _),) = test_net.main(["--config-file", faster_yaml, "--ckpt",
                                 os.path.join(out, "model_final.pth"),
                                 "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
                                 "OUTPUT_DIR", os.path.join(out, "test")])
    dl.done("faster_r101_test", t0, {"nms": 2, "roi_align": 1}, 1)
    print("faster R-101 test_net on 8 images (SCORE_THRESH 0 for random heads) [{}]: {}".format(
        card, json.dumps(dict(res.results["bbox"]))), flush=True)
    return sites


def kernel_path_sites(**found):
    """A path's kernel sites by kernel (empty where the path runs none)."""
    return {k: found.get(k, []) for k in ("nms", "roi_align", "roi_align_backward", "matcher")}


def coco_minival(dl):
    """Phase 24's val2014 annotations and the path of coco_2014_minival's
    annotation file, which each test pass writes anew."""
    ann_dir = os.path.join(dl.work, "coco", "annotations")
    with open(os.path.join(ann_dir, "instances_valminusminival2014.json")) as f:
        val = json.load(f)
    return val, os.path.join(ann_dir, "instances_minival2014.json")


def coco_known_answer(torch, np, card, dl, path, yaml, ckpt, out, per_batch, opts=()):
    """test_net on coco_2014_minival (the first FAMILY_TEST_IMAGES of the
    val2014 images, one batch of 8, SCORE_THRESH 0 for random heads, bbox
    and segm), then its predictions evaluated
    against themselves as the gt, boxes and pasted masks (RLE, which the
    evaluator reads and the dataset's poly targets do not): AP50 >= 0.99.
    A detection whose pasted mask holds no pixel is no segm answer: it
    leaves the segm gt and predictions (counted)."""
    import pickle

    from maskrcnn_tpu_torch.data.datasets import COCODataset
    from maskrcnn_tpu_torch.data.evaluation.coco_eval import (
        do_coco_evaluation,
        prepare_for_coco_segmentation,
    )
    from maskrcnn_tpu_torch.tools import test_net
    from maskrcnn_tpu_torch.utils import maskops

    val, minival = coco_minival(dl)
    images = val["images"][:FAMILY_TEST_IMAGES]
    ids = {info["id"] for info in images}
    write_coco_json(minival, images, [a for a in val["annotations"] if a["image_id"] in ids],
                    range(1, 81))
    test_opts = ["--config-file", yaml, "--ckpt", ckpt, "MODEL.ROI_HEADS.SCORE_THRESH",
                 "0.0"] + list(opts)
    t0 = dl.reset()
    ((res, _),) = test_net.main(test_opts + ["OUTPUT_DIR", out])
    dl.done(path, t0, per_batch, FAMILY_TEST_IMAGES // 8)
    check(set(res.results) == {"bbox", "segm"}, "{} evaluated {}".format(path, set(res.results)))
    with open(os.path.join(out, "inference", "coco_2014_minival", "predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    gts = detections_as_gt(preds, images)
    root = os.path.join(dl.work, "coco", "val2014")
    rles = prepare_for_coco_segmentation(preds, COCODataset(minival, root))
    masks = [r["segmentation"] for info in images for r in rles[info["id"]]]
    check(len(masks) == len(gts), "{} masks for {} detections".format(len(masks), len(gts)))
    for a, m in zip(gts, masks):
        a["segmentation"] = m
    filled = [[maskops.rle_area(r["segmentation"]) > 0 for r in rles[info["id"]]]
              for info in images]
    known = {}
    for iou_type, anns, dets in (
            ("bbox", gts, preds),
            ("segm", [a for a, f in zip(gts, sum(filled, [])) if f],
             [p[np.asarray(f, bool)] for p, f in zip(preds, filled)])):
        known_json = os.path.join(out, "known_answer_{}.json".format(iou_type))
        write_coco_json(known_json, images, anns, range(1, 81))
        r, _ = do_coco_evaluation(COCODataset(known_json, root), dets, False, None,
                                  [iou_type], (), 4)
        known[iou_type] = dict(r.results[iou_type])
    known = {"first_pass": {k: dict(v) for k, v in res.results.items()},
             "gt_from_detections": len(gts), "empty_masks": len(gts) - sum(map(sum, filled)),
             "known_answer": known}
    print("{} test_net on {} images at TEST.IMS_PER_BATCH 8, then its known answer "
          "(the detections' boxes and masks as gt) [{}]: {}".format(path, len(images), card,
                                                                  json.dumps(known)), flush=True)
    check(min(known["known_answer"][k]["AP50"] for k in ("bbox", "segm")) >= 0.99,
          "{} known-answer AP50 {}".format(path, known["known_answer"]))
    return known


def serve_once(torch, np, card, dl, path, cfg, seed, per_request, prepare=None):
    """One request of 480x640 through Predictor from the config (its
    catalog:// weights from the cache), after a warm-up; prepare(predictor,
    warm-up image), when given, runs first (the frozen-BN calibration of a
    body without weights). Returns the served config and the weights."""
    from maskrcnn_tpu_torch.predictor import Predictor

    scfg = cfg.clone()
    scfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    pred = Predictor(scfg, device="cuda", seed=seed, min_image_size=scfg.INPUT.MIN_SIZE_TEST)
    rs = np.random.RandomState(seed)
    warm, img = (rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(2))
    if prepare is not None:
        prepare(pred, warm)
    pred.compute_prediction(warm)
    t0 = dl.reset()
    t1 = time.perf_counter()
    o = pred.compute_prediction(img)
    ms = (time.perf_counter() - t1) * 1e3
    dl.done(path, t0, per_request, 1)
    n = len(o["scores"])
    rpn_cfg = scfg.MODEL.RPN
    if scfg.MODEL.RPN_ONLY:  # the proposals
        cap = rpn_cfg.FPN_POST_NMS_TOP_N_TEST if rpn_cfg.USE_FPN else rpn_cfg.POST_NMS_TOP_N_TEST
        labels = o["labels"] == 1
    else:
        cap = scfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
        labels = (o["labels"] >= 1) & (o["labels"] <= 80)
    check(0 < n <= cap and np.isfinite(o["boxes"]).all()
          and labels.all() and (not scfg.MODEL.MASK_ON or o["masks"].shape == (n, 480, 640)),
          "{} request: {}".format(path, {k: v.shape for k, v in o.items()}))
    state = {k: v.detach().cpu().clone() for k, v in pred.model.state_dict().items()}
    del pred
    torch.cuda.empty_cache()
    print("{}: one 480x640 request in {:.2f} ms, {} detections [{}]".format(path, ms, n, card),
          flush=True)
    return scfg, state


def step_profile_shares(torch, card, dl, path, targets):
    """A run's recorded training step profiled once: profile_summary's
    reading and what each function of `targets` takes of its device busy
    time (function_shares), one busy time for both."""
    from maskrcnn_tpu_torch.utils import profiling

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shares = profiling.function_shares(targets, dl.record["step"], dl.record["batch"], steps=1,
                                       summary=True)
    prof = shares.pop("profile")
    del shares["wall_ms"], shares["device_busy_ms"]  # prof's own
    prof["peak_step_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for label in targets:
        got = shares[label]
        check(got["calls"] > 0, "{}: no call of {} in the profiled step".format(path, label))
        check(not isinstance(got.get("ms"), float) or got["ms"] <= prof["device_busy_ms"],
              "{}: {} takes more than the step: {}".format(path, label, shares))
    prof["shares"] = shares
    print("{} step, torch.profiler [{}]: {}".format(path, card, json.dumps(
        {k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share", "peak_step_gb",
                                  "top_kernels_ms", "shares")})), flush=True)
    return prof


def gn_c4_phase(torch, np, card, dl):
    """32-33. The GN and C4 families as written, on phase 24's COCO trees and
    weight cache (dl: the data-layer phases' work tree, cache and helpers):
    GN Mask R-CNN (Xconv1fc head) from a synthetic R-50-GN.pkl and Mask
    R-CNN R-50-C4 from the cache's R-50.pkl, each through train_net for 3
    iterations, test_net with a known answer and a Predictor request; the
    C4 quick file through test_net alone. Returns the kernel sites and the
    wall seconds by path."""
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config.paths_catalog import ModelCatalog
    from maskrcnn_tpu_torch.models import build_detection_model, detector, layers, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils.model_zoo import cached_name

    sites, phase_s = {}, {}
    path_sites = kernel_path_sites
    val, minival = coco_minival(dl)

    def known_answer(path, yaml, ckpt, out, per_batch, opts=()):
        return coco_known_answer(torch, np, card, dl, path, yaml, ckpt, out, per_batch, opts)

    def serve(path, cfg, seed, per_request):
        return serve_once(torch, np, card, dl, path, cfg, seed, per_request)

    def step_profile(path, targets):
        return step_profile_shares(torch, card, dl, path, targets)

    # 32. GN Mask R-CNN R-50-FPN, Xconv1fc head, from a synthetic R-50-GN.pkl
    t0 = dl.reset()
    gn_yaml = os.path.join(REPO, "configs", "gn_baselines",
                           "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml")
    cfg = defaults.clone()
    cfg.merge_from_file(gn_yaml)
    check(cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50-GN"
          and cfg.MODEL.RESNETS.TRANS_FUNC == "BottleneckWithGN" and cfg.MODEL.FPN.USE_GN
          and cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR == "FPNXconv1fcFeatureExtractor"
          and cfg.SOLVER.IMS_PER_BATCH == 16 and cfg.TPU.COMPUTE_DTYPE == "bfloat16",
          "the GN YAML reads {}".format(cfg.MODEL.WEIGHT))
    model = build_detection_model(cfg, device="cuda", seed=SEED + 20)
    # each block's last group norm and its shortcut's at R50_RESIDUAL_SCALE,
    # as the synthetic R-50.pkl's frozen BN
    body = {k: v.cpu().numpy() * (R50_RESIDUAL_SCALE if k.endswith(("bn3.scale",
                                                                    "downsample.bn.scale")) else 1)
            for k, v in model.state_dict().items() if k.startswith("backbone.body.")}
    del model
    gn_pkl = os.path.join(dl.cache, cached_name(ModelCatalog.get("ImageNetPretrained/MSRA/R-50-GN")))
    write_pkl(gn_pkl, detectron_blobs(np, body, imagenet=True, seed=SEED), wrap=False)
    out = os.path.join(dl.work, "gn")
    print("gn recipe: train_net --config-file configs/gn_baselines/"
          "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml --skip-test SOLVER.MAX_ITER 3 OUTPUT_DIR "
          "<dir> (batch 16 on phase 24's trees; a synthetic R-50-GN.pkl of {:.1f} MB in the "
          "cache: the seeded GN body, each block's last group norm and its shortcut's at scale "
          "{})".format(os.path.getsize(gn_pkl) / 1e6, R50_RESIDUAL_SCALE), flush=True)
    torch.cuda.reset_peak_memory_stats()
    with dl.first_step(pooled=2) as caps:
        _, meters = train_net.main(["--config-file", gn_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        # 69 group norms a step (stem 1, the blocks 52, FPN 8, box and mask
        # heads 4 each), 58 with a backward (not the frozen stem and res2's 11)
        dl.done("gn_recipe", t0, {"matcher": 1, "nms": 1, "roi_align": 2,
                                  "roi_align_backward": 2, "group_norm": 69,
                                  "group_norm_backward": 58}, 3)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    n_loaded, n_total = dl.loaded_count()
    check(n_loaded == len(body), "R-50-GN.pkl loaded {} of the body's {} tensors".format(
        n_loaded, len(body)))
    check(all(torch.equal(dl.record["start"][k].cpu(), torch.from_numpy(v).float())
              for k, v in body.items()), "the GN body's tensors differ from the R-50-GN.pkl blobs")
    summary = dl.train_summary(meters, gn_yaml, n_losses=5)
    sites["gn_recipe"], _ = dl.step_sites("gn recipe", caps, 16, (80, 2000), pooled=2)
    del caps
    sites["gn_recipe"].update(group_norm_sites(torch, card))
    # a label of its own: layers.group_norm opens a span "group_norm" inside it
    step_profile("gn recipe", {"group_norms": (layers, "group_norm")})
    print("gn recipe: loaded {}/{} tensors from R-50-GN.pkl, the body's equal to its blobs; 3 "
          "iterations at batch 16: {}; peak memory {:.3f} GB over the run [{}]".format(
              n_loaded, n_total, json.dumps(summary), peak_run_gb, card), flush=True)
    dl.record.clear()
    sites["gn_known"] = path_sites()
    known_answer("gn_test", gn_yaml, os.path.join(out, "model_final.pth"), os.path.join(out, "test"),
                 {"nms": 2, "roi_align": 2, "group_norm": 69})
    scfg, state = serve("gn_serving", cfg, SEED + 21, {"nms": 2, "roi_align": 2,
                                                       "group_norm": 69})
    ref = reference_check(torch, np, detector, scfg, state)
    print("gn float32 card vs CPU on a 256x320 image [{}]: {}".format(card, json.dumps(ref)),
          flush=True)
    check(ref["agree"] >= 0.9, "GN: card and CPU disagree on {:.1%} of detections".format(
        1 - ref["agree"]))
    phase_s["gn"] = time.perf_counter() - t0

    # 33. Mask R-CNN R-50-C4 from the cache's R-50.pkl
    t0 = dl.reset()
    c4_yaml = os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_C4_1x.yaml")
    cfg = defaults.clone()
    cfg.merge_from_file(c4_yaml)
    check(cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50"
          and cfg.MODEL.BACKBONE.CONV_BODY == "R-50-C4" and cfg.SOLVER.IMS_PER_BATCH == 8
          and cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO == 0
          and cfg.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR
          and cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN == 12000, "the C4 YAML reads {}".format(
              cfg.MODEL.BACKBONE.CONV_BODY))
    out = os.path.join(dl.work, "c4")
    print("c4 recipe: train_net --config-file configs/e2e_mask_rcnn_R_50_C4_1x.yaml --skip-test "
          "SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (batch 8 on phase 24's trees, its catalog:// R-50 "
          "from the cache: res2-res4 into the body, res5 into the box head)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    caps = {"nms": Capture([rpn], "batched_nms", limit=1),
            "matcher": Capture([rpn], "match_anchors_batched", limit=1),
            "pool": Capture([detector], "multilevel_roi_align", grads=True, limit=2)}
    with contextlib.ExitStack() as stack:
        for c in caps.values():
            stack.enter_context(c)
        _, meters = train_net.main(["--config-file", c4_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        dl.done("c4_recipe", t0, {"matcher": 1, "nms": 1, "roi_align": 2,
                                  "roi_align_backward": 2}, 3)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    n_loaded, n_total = dl.loaded_count()
    head = [k for k in dl.record["start"] if k.startswith("roi_heads.box.feature_extractor.head.")
            and not k.endswith(("running_mean", "running_var"))]
    check(n_loaded > len(head) > 0, "R-50.pkl loaded {} tensors into the C4 model".format(n_loaded))
    summary = dl.train_summary(meters, c4_yaml, n_losses=5)
    lane = caps["nms"].calls[0]
    with torch.no_grad():
        nms_c4 = nms_site(torch, nms, *lane, plain_iters=1)
    check(nms_c4["shape"] == [8, 12000], "C4 training NMS lanes {}".format(nms_c4["shape"]))
    msite = matcher_site(torch, matcher, *caps["matcher"].calls[0])
    check(msite["images"] == 8, "C4 matcher on {} images".format(msite["images"]))
    # the box and mask poolers: the kernels' adaptive instances against the
    # gather path, forward and backward, on the first step's inputs and the
    # gradients its backward gave them
    pool_fwd, pool_bwd = adaptive_pooler_sites(torch, poolers, caps["pool"], "c4 recipe")
    box_rois = 8 * cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    check([(x["rois"], x["P"]) for x in pool_fwd][:1] == [(box_rois, 14)]
          and len(pool_fwd) == len(pool_bwd) == 2
          and [x["rois"] for x in pool_bwd] == [x["rois"] for x in pool_fwd],
          "C4 training pooler sites {}".format([(x["rois"], x["P"]) for x in pool_fwd]))
    for x in pool_fwd + pool_bwd:
        print("c4 recipe kernel site, the {} pooler {} [{}]: {}".format(
            "box" if x["rois"] == box_rois else "mask", "backward" if "kind" in x else "forward",
            card, json.dumps(x)), flush=True)
    for c in caps.values():
        c.calls.clear()
    del caps, lane
    step_profile("c4 recipe", {"res5_head": (box_head.ResNet50Conv5ROIFeatureExtractor, "forward"),
                               "pooler": (detector, "multilevel_roi_align")})
    print("c4 recipe: loaded {}/{} tensors from R-50.pkl; 3 iterations at batch 8: {}; peak "
          "memory {:.3f} GB over the run [{}]".format(n_loaded, n_total, json.dumps(summary),
                                                      peak_run_gb, card), flush=True)
    print("c4 recipe kernel sites [{}]: {} {}".format(card, json.dumps(nms_c4), json.dumps(msite)),
          flush=True)
    sites["c4_recipe"] = path_sites(nms=[nms_c4], matcher=[msite], roi_align=pool_fwd,
                                    roi_align_backward=pool_bwd)
    dl.record.clear()
    with Capture([rpn], "batched_nms", limit=1) as cap, \
            Capture([detector], "multilevel_roi_align", limit=2) as pool:
        known_answer("c4_test", c4_yaml, os.path.join(out, "model_final.pth"),
                     os.path.join(out, "test"), {"nms": 2, "roi_align": 2})
    with torch.inference_mode():
        test_lane = nms_site(torch, nms, *cap.calls[0], plain_iters=1)
        test_pool, _ = adaptive_pooler_sites(torch, poolers, pool, "c4 test")
    check(test_lane["shape"] == [8, 6000], "C4 test NMS lanes {}".format(test_lane["shape"]))
    check([x["P"] for x in test_pool] == [14, 14],
          "C4 test pooler sites {}".format([(x["rois"], x["P"]) for x in test_pool]))
    print("c4 test kernel site, the RPN's NMS [{}]: {}".format(card, json.dumps(test_lane)),
          flush=True)
    for x, name in zip(test_pool, ("box", "mask")):
        print("c4 test kernel site, the {} pooler forward [{}]: {}".format(
            name, card, json.dumps(x)), flush=True)
    sites["c4_test"] = path_sites(nms=[test_lane], roi_align=test_pool)
    del cap, pool
    serve("c4_serving", cfg, SEED + 22, {"nms": 2, "roi_align": 2})
    # the quick file through test_net alone, at a short side of 480
    t1 = dl.reset()
    quick = os.path.join(REPO, "configs", "quick_schedules", "e2e_faster_rcnn_R_50_C4_quick.yaml")
    write_coco_json(minival, val["images"], val["annotations"], range(1, 81))
    ((res, _),) = test_net.main(["--config-file", quick, "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
                                 "INPUT.MIN_SIZE_TEST", "480", "INPUT.MAX_SIZE_TEST", "640",
                                 "OUTPUT_DIR", os.path.join(out, "quick")])
    dl.done("c4_quick_test", t1, {"nms": 2, "roi_align": 1}, 2)
    print("c4 quick: test_net --config-file configs/quick_schedules/"
          "e2e_faster_rcnn_R_50_C4_quick.yaml INPUT.MIN_SIZE_TEST 480 INPUT.MAX_SIZE_TEST 640 "
          "(its catalog:// R-50 from the cache, random heads) [{}]: {}".format(
              card, json.dumps(dict(res.results["bbox"]))), flush=True)
    phase_s["c4"] = time.perf_counter() - t0
    return sites, phase_s


def calibrate_unfolded_bn(torch, model, run):
    """Set every frozen BN that runs as its own module (not folded into its
    conv: FBNet's, a deformable conv's) from the first input it meets while
    run() runs: running mean and variance (+1e-5) of that input, weight 1,
    bias 0. Returns (BNs set, BNs in the model)."""
    from maskrcnn_tpu_torch.models.layers import FrozenBatchNorm2d

    seen = set()

    def pre(mod, args):
        if id(mod) in seen:
            return
        seen.add(id(mod))
        x = args[0].float()
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3)) + 1e-5)
        mod.weight.fill_(1.0)
        mod.bias.zero_()

    bns = [m for m in model.modules() if isinstance(m, FrozenBatchNorm2d)]
    hooks = [m.register_forward_pre_hook(pre) for m in bns]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return len(seen), len(bns)


def dcn_block_check(torch, np, card):
    """A deformable (v2) bottleneck of layer2's widths (256 -> 128 -> 512,
    stride 2) with seeded weights, offsets of about a cell and random frozen
    BN, on a 2 x 256 x 20 x 24 input: float32 on the card (no TF32) against
    the CPU (PyTorch's own convolutions), the output within 1e-5 of its
    largest value and every gradient (input, offset conv, convs) within
    2e-4 of its largest value."""
    import copy

    from maskrcnn_tpu_torch.models.resnet import Bottleneck

    gen = torch.Generator().manual_seed(SEED + 40)
    block = Bottleneck(256, 128, 512, stride=2, dilation=1, num_groups=1, stride_in_1x1=True,
                       dcn=dict(modulated=True, deformable_groups=1))
    block.reset_parameters(gen)
    with torch.no_grad():
        block.conv2_offset.weight.normal_(0, (9 * 128) ** -0.5, generator=gen)
        block.conv2_offset.bias.normal_(0, 0.3, generator=gen)
        for bn in (block.bn1, block.bn2, block.bn3, block.downsample.bn):
            c = bn.weight.numel()
            bn.weight.uniform_(0.3, 0.7, generator=gen)
            bn.bias.uniform_(-0.1, 0.1, generator=gen)
            bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    x = torch.randn(2, 256, 20, 24, generator=gen)
    cot = torch.randn(2, 512, 10, 12, generator=gen)
    got = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            b = copy.deepcopy(block).to(dev)
            xx = x.to(dev).requires_grad_()
            with torch.backends.mkldnn.flags(enabled=False):
                out = b(xx)
                (out * cot.to(dev)).sum().backward()
            got[dev] = dict({"out": out.detach().cpu(), "x": xx.grad.cpu()},
                            **{n: p.grad.cpu() for n, p in b.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = {k: ((got["cuda"][k] - v).abs().max() / v.abs().max()).item()
           for k, v in got["cpu"].items()}
    print("dcn bottleneck, float32 card vs CPU (v2, 256-128-512, stride 2, offsets of about a "
          "cell), error over each tensor's largest value [{}]: {}".format(card, json.dumps(rel)),
          flush=True)
    check(rel["out"] <= 1e-5 and all(v <= 2e-4 for v in rel.values()),
          "DCN bottleneck card vs CPU: {}".format(rel))
    return rel


def last_families_phase(torch, np, card, dl):
    """34-36. The last three families as written, on phase 24's COCO trees and
    weight cache (dl: the data-layer phases' work tree, cache and helpers):
    RPN-only R-50-FPN (train_net, test_net with box-proposal recall and a
    known answer, a Predictor request) and R-50-C4 (test_net); deformable
    Mask R-CNN v2 (train_net, test_net with a known answer) and v1 Faster
    R-CNN (test_net), a deformable bottleneck card against CPU; FBNet Mask
    R-CNN (train_net, test_net with a known answer) and two FBNet files
    served. Returns the kernel sites and the wall seconds by path."""
    import gc
    import pickle

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, resnet, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.tools import test_net, train_net

    sites, phase_s = {}, {}
    val, minival = coco_minival(dl)
    r50 = "catalog://ImageNetPretrained/MSRA/R-50"
    eight = {i["id"] for i in val["images"][:8]}

    def first_eight():
        write_coco_json(minival, val["images"][:8],
                        [a for a in val["annotations"] if a["image_id"] in eight], range(1, 81))

    def cfg_of(yaml):
        c = defaults.clone()
        c.merge_from_file(yaml)
        return c

    # 34. RPN-only R-50-FPN from the cache's R-50.pkl, then R-50-C4
    t0 = dl.reset()
    rpn_yaml = os.path.join(REPO, "configs", "rpn_R_50_FPN_1x.yaml")
    cfg = cfg_of(rpn_yaml)
    check(cfg.MODEL.RPN_ONLY and cfg.MODEL.WEIGHT == r50 and cfg.SOLVER.IMS_PER_BATCH == 16
          and cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST == 2000,
          "the RPN-only YAML reads {}".format(cfg.MODEL.WEIGHT))
    out = os.path.join(dl.work, "rpn")
    print("rpn recipe: train_net --config-file configs/rpn_R_50_FPN_1x.yaml --skip-test "
          "SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (batch 16 on phase 24's trees, its catalog:// "
          "R-50 from the cache)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with Capture([rpn], "match_anchors_batched", limit=1) as cap:
        _, meters = train_net.main(["--config-file", rpn_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        # the matcher once a step, no proposals: no NMS
        dl.done("rpn_recipe", t0, {"matcher": 1}, 3)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    n_loaded, n_total = dl.loaded_count()
    summary = dl.train_summary(meters, rpn_yaml, n_losses=2)
    msite = matcher_site(torch, matcher, *cap.calls[0])
    check(msite["images"] == 16, "RPN-only matcher on {} images".format(msite["images"]))
    del cap
    sites["rpn_recipe"] = kernel_path_sites(matcher=[msite])
    print("rpn recipe: loaded {}/{} tensors from R-50.pkl; 3 iterations at batch 16: {}; peak "
          "memory {:.3f} GB over the run; matcher site [{}]: {}".format(
              n_loaded, n_total, json.dumps(summary), peak_run_gb, card, json.dumps(msite)),
          flush=True)
    dl.record.clear()

    def proposals_test(path, opts, out_dir):
        """test_net of the RPN-only file on coco_2014_minival: the box-proposal
        recalls, the RPN's NMS lanes of each batch held to the plain
        version, and the predictions."""
        t1 = dl.reset()
        with Capture([rpn], "batched_nms") as nms_cap:
            ((res, _),) = test_net.main(["--config-file", rpn_yaml] + opts
                                        + ["OUTPUT_DIR", out_dir])
            dl.done(path, t1, {"nms": 1}, 2)
        check(set(res.results) == {"box_proposal"}, "{} evaluated {}".format(path, res.results))
        with torch.inference_mode():
            lanes = [nms_site(torch, nms, *c, plain_iters=1) for c in nms_cap.calls]
        check([s_["shape"] for s_ in lanes] == [[40, 1000]] * 2,
              "{} NMS lanes {}".format(path, [s_["shape"] for s_ in lanes]))
        with open(os.path.join(out_dir, "inference", "coco_2014_minival", "predictions.pkl"),
                  "rb") as f:
            preds = pickle.load(f)
        return dict(res.results["box_proposal"]), lanes, preds

    write_coco_json(minival, val["images"], val["annotations"], range(1, 81))
    ckpt = ["--ckpt", os.path.join(out, "model_final.pth")]
    first, lanes, preds = proposals_test("rpn_test", ckpt, os.path.join(out, "test"))
    # a known answer: each image's 20 first proposals (in objectness order)
    # as its gt; the second pass's proposals hold each of them exactly
    top = [p[np.arange(min(len(p), 20))] for p in preds]
    check(all(len(p) == 20 for p in top), "proposals an image: {}".format([len(p) for p in preds]))
    write_coco_json(minival, val["images"], detections_as_gt(top, val["images"]), range(1, 81))
    second, _, _ = proposals_test("rpn_known", ckpt, os.path.join(out, "known"))
    known = {"first_pass": first, "gt_from_proposals": 20 * len(top), "known_answer": second}
    print("rpn test_net on 16 images at TEST.IMS_PER_BATCH 8 (box-proposal recall), then its known "
          "answer (each image's 20 first proposals as gt) [{}]: {}".format(card, json.dumps(known)),
          flush=True)
    check(second["AR@1000"] >= 0.99 and second["AR@100"] >= 0.99,
          "RPN-only known-answer recall {}".format(second))
    for s_ in lanes:
        print("rpn test kernel site, the RPN's NMS [{}]: {}".format(card, json.dumps(s_)),
              flush=True)
    sites["rpn_test"] = kernel_path_sites(nms=lanes)
    sites["rpn_known"] = kernel_path_sites()
    serve_once(torch, np, card, dl, "rpn_serving", cfg, SEED + 30, {"nms": 1})
    # R-50-C4 RPN-only through test_net on 8 images
    t1 = dl.reset()
    c4_yaml = os.path.join(REPO, "configs", "rpn_R_50_C4_1x.yaml")
    first_eight()
    with Capture([rpn], "batched_nms", limit=1) as nms_cap:
        ((res, _),) = test_net.main(["--config-file", c4_yaml,
                                     "OUTPUT_DIR", os.path.join(dl.work, "rpn_c4")])
        dl.done("rpn_c4_test", t1, {"nms": 1}, 1)
    with torch.inference_mode():
        c4_lane = nms_site(torch, nms, *nms_cap.calls[0], plain_iters=1)
    del nms_cap
    check(c4_lane["shape"] == [8, 6000], "RPN-only C4 NMS lanes {}".format(c4_lane["shape"]))
    sites["rpn_c4_test"] = kernel_path_sites(nms=[c4_lane])
    print("rpn c4: test_net --config-file configs/rpn_R_50_C4_1x.yaml on 8 images (its catalog:// "
          "R-50 from the cache) [{}]: {}; the RPN's NMS: {}".format(
              card, json.dumps(dict(res.results["box_proposal"])), json.dumps(c4_lane)),
          flush=True)
    phase_s["rpn_only"] = time.perf_counter() - t0

    # 35. Deformable convs: Mask R-CNN v2 from the cache's R-50.pkl
    t0 = time.perf_counter()
    dcn_yaml = os.path.join(REPO, "configs", "dcn", "e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml")
    cfg = cfg_of(dcn_yaml)
    check(cfg.MODEL.WEIGHT == r50 and tuple(cfg.MODEL.RESNETS.STAGE_WITH_DCN)
          == (False, True, True, True) and cfg.MODEL.RESNETS.WITH_MODULATED_DCN
          and cfg.SOLVER.IMS_PER_BATCH == 16, "the DCN YAML reads {}".format(cfg.MODEL.RESNETS))
    out = os.path.join(dl.work, "dcn")
    batch, opts = 16, []
    while True:
        print("dcn recipe: train_net --config-file configs/dcn/e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml "
              "--skip-test SOLVER.MAX_ITER 3 OUTPUT_DIR <dir>{} (batch {} on phase 24's trees, "
              "its catalog:// R-50 from the cache)".format(
                  "".join(" " + o for o in opts), batch), flush=True)
        t1 = dl.reset()
        torch.cuda.reset_peak_memory_stats()
        try:
            with dl.first_step(pooled=2) as caps:
                _, meters = train_net.main(["--config-file", dcn_yaml, "--skip-test",
                                            "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out] + opts)
                dl.done("dcn_recipe", t1, {"matcher": 1, "nms": 1, "roi_align": 2,
                                           "roi_align_backward": 2}, 3)
            break
        except torch.cuda.OutOfMemoryError as e:
            check(batch > 4, "DCN training does not fit at batch {}: {}".format(batch, e))
            print("dcn recipe: batch {} does not fit on the card ({}); the batch is cut to {}"
                  .format(batch, str(e).splitlines()[0], batch // 2), flush=True)
            caps = None
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(out, ignore_errors=True)
            batch //= 2
            opts = ["SOLVER.IMS_PER_BATCH", str(batch)]
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    n_loaded, n_total = dl.loaded_count()
    offsets = [k for k in dl.record["start"] if "conv2_offset" in k]
    body = [k for k in dl.record["start"] if k.startswith("backbone.body.")
            and not k.endswith(("running_mean", "running_var"))]
    # every tensor of the body but the offset convs, which Detectron's R-50 lacks
    check(len(offsets) == 26 and all(not dl.record["start"][k].any() for k in offsets)
          and n_loaded == len(body) - len(offsets),
          "R-50.pkl loaded {}/{} tensors into the DCN model; offset convs {}".format(
              n_loaded, n_total, len(offsets)))
    summary = dl.train_summary(meters, dcn_yaml, opts, n_losses=5)
    sites["dcn_recipe"], _ = dl.step_sites("dcn recipe", caps, batch, (batch * 5, 2000), pooled=2)
    del caps
    prof = step_profile_shares(torch, card, dl, "dcn recipe", {
        "deformable_block": (resnet.Bottleneck, "deform"),
        "deform_conv2d": (resnet, "deform_conv2d")})
    print("dcn recipe: loaded {}/{} tensors from R-50.pkl (the 26 offset-conv tensors at their "
          "zero init); 3 iterations at batch {}: {}; peak memory {:.3f} GB over the run, "
          "{:.3f} GB in the profiled step [{}]".format(
              n_loaded, n_total, batch, json.dumps(summary), peak_run_gb, prof["peak_step_gb"],
              card), flush=True)
    dl.record.clear()
    sites["dcn_test"] = kernel_path_sites()
    coco_known_answer(torch, np, card, dl, "dcn_test", dcn_yaml,
                      os.path.join(out, "model_final.pth"), os.path.join(out, "test"),
                      {"nms": 2, "roi_align": 2})
    # the v1 Faster file through test_net on 8 images
    t1 = dl.reset()
    first_eight()
    v1_yaml = os.path.join(REPO, "configs", "dcn", "e2e_faster_rcnn_dconv_R_50_FPN_1x.yaml")
    ((res, _),) = test_net.main(["--config-file", v1_yaml, "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
                                 "OUTPUT_DIR", os.path.join(dl.work, "dcn_v1")])
    dl.done("dcn_v1_test", t1, {"nms": 2, "roi_align": 1}, 1)
    sites["dcn_v1_test"] = kernel_path_sites()
    print("dcn v1: test_net --config-file configs/dcn/e2e_faster_rcnn_dconv_R_50_FPN_1x.yaml on 8 "
          "images (its catalog:// R-50 from the cache, random heads) [{}]: {}".format(
              card, json.dumps(dict(res.results["bbox"]))), flush=True)
    dcn_block_check(torch, np, card)
    phase_s["dcn"] = time.perf_counter() - t0

    # 36. FBNet Mask R-CNN at the per-card share of its published batch
    t0 = time.perf_counter()
    fb_yaml = os.path.join(REPO, "configs", "e2e_mask_rcnn_fbnet.yaml")
    cfg = cfg_of(fb_yaml)
    check(cfg.MODEL.BACKBONE.CONV_BODY == "FBNet" and not cfg.MODEL.WEIGHT
          and cfg.SOLVER.IMS_PER_BATCH == 128 and cfg.MODEL.RPN.RPN_HEAD == "FBNet.rpn_head",
          "the FBNet YAML reads {}".format(cfg.MODEL.BACKBONE.CONV_BODY))
    # the seeded model, each frozen BN set from 8 of phase 24's images (the
    # file names no weights), handed to train_net as its MODEL.WEIGHT
    model = build_detection_model(cfg, device="cuda", seed=SEED + 50)
    images = torch.from_numpy(np.stack([dl.coco["train2014"][i] for i in range(1, 9)])).cuda()
    sizes = torch.tensor([[480, 640]] * 8, dtype=torch.int32, device="cuda")
    n_set, n_bn = calibrate_unfolded_bn(torch, model, lambda: model.infer_forward(
        {"images": images, "image_sizes": sizes}))
    check(n_set == n_bn > 0, "calibrated {} of {} FBNet BNs".format(n_set, n_bn))
    weights = os.path.join(dl.work, "fbnet_seeded.pth")
    torch.save({"model": model.state_dict()}, weights)
    del model, images
    out = os.path.join(dl.work, "fbnet")
    opts = ["SOLVER.IMS_PER_BATCH", "16", "MODEL.WEIGHT", weights]
    print("fbnet recipe: train_net --config-file configs/e2e_mask_rcnn_fbnet.yaml --skip-test "
          "SOLVER.MAX_ITER 2 SOLVER.IMS_PER_BATCH 16 (the published 128 over 8 cards: 16 a card) "
          "MODEL.WEIGHT <the seeded model, its {} frozen BNs set from 8 images> OUTPUT_DIR <dir> "
          "(phase 24's trees at 320-640 px)".format(n_bn), flush=True)
    t1 = dl.reset()
    torch.cuda.reset_peak_memory_stats()
    caps = {"nms": Capture([rpn], "batched_nms", limit=1),
            "matcher": Capture([rpn], "match_anchors_batched", limit=1),
            "pool": Capture([detector], "multilevel_roi_align", grads=True, limit=2)}
    with contextlib.ExitStack() as stack:
        for c in caps.values():
            stack.enter_context(c)
        _, meters = train_net.main(["--config-file", fb_yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", out] + opts)
        # the adaptive pooler on the single stride-16 map: the kernels' adaptive
        # instances, box and mask
        dl.done("fbnet_recipe", t1, {"matcher": 1, "nms": 1, "roi_align": 2,
                                     "roi_align_backward": 2}, 2)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = dl.train_summary(meters, fb_yaml, opts, n_losses=5, frozen_prefixes=())
    with torch.no_grad():
        fb_nms = nms_site(torch, nms, *caps["nms"].calls[0], plain_iters=1)
    fb_matcher = matcher_site(torch, matcher, *caps["matcher"].calls[0])
    check(fb_nms["shape"] == [16, 6000] and fb_matcher["images"] == 16,
          "FBNet NMS lanes {}, matcher on {} images".format(fb_nms["shape"],
                                                          fb_matcher["images"]))
    fb_fwd, fb_bwd = adaptive_pooler_sites(torch, poolers, caps["pool"], "fbnet recipe")
    check(len(fb_fwd) == len(fb_bwd) == 2, "FBNet pooler sites {} / {}".format(
        len(fb_fwd), len(fb_bwd)))
    for x in fb_fwd + fb_bwd:
        print("fbnet recipe kernel site, a pooler {} [{}]: {}".format(
            "backward" if "kind" in x else "forward", card, json.dumps(x)), flush=True)
    for c in caps.values():
        c.calls.clear()
    del caps
    sites["fbnet_recipe"] = kernel_path_sites(nms=[fb_nms], matcher=[fb_matcher],
                                              roi_align=fb_fwd, roi_align_backward=fb_bwd)
    prof = step_profile_shares(torch, card, dl, "fbnet recipe", {
        "pooler": (detector, "multilevel_roi_align")})
    print("fbnet recipe: 2 iterations at batch 16: {}; peak memory {:.3f} GB over the run, "
          "{:.3f} GB in the profiled step; kernel sites [{}]: {} {}".format(
              json.dumps(summary), peak_run_gb, prof["peak_step_gb"], card, json.dumps(fb_nms),
              json.dumps(fb_matcher)), flush=True)
    dl.record.clear()
    sites["fbnet_test"] = kernel_path_sites()
    coco_known_answer(torch, np, card, dl, "fbnet_test", fb_yaml,
                      os.path.join(out, "model_final.pth"), os.path.join(out, "test"),
                      {"nms": 2, "roi_align": 2})

    def calibrated(pred, warm):
        n_set, n_bn = calibrate_unfolded_bn(torch, pred.model,
                                            lambda: pred.compute_prediction(warm))
        check(n_set == n_bn > 0, "calibrated {} of {} FBNet BNs".format(n_set, n_bn))

    for k, name in enumerate(("e2e_faster_rcnn_fbnet_chamv1a_600.yaml",
                              "e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml")):
        scfg, state = serve_once(torch, np, card, dl, "fbnet_serving_" + name.split("_")[-2],
                                 cfg_of(os.path.join(REPO, "configs", name)), SEED + 51 + k,
                                 {"nms": 2, "roi_align": 1 + k}, prepare=calibrated)
        sites["fbnet_serving_" + name.split("_")[-2]] = kernel_path_sites()
    ref = reference_check(torch, np, detector, scfg, state)
    print("fbnet xirb16d_dsmask float32 card vs CPU on a 256x320 image [{}]: {}".format(
        card, json.dumps(ref)), flush=True)
    check(ref["agree"] >= 0.9, "FBNet: card and CPU disagree on {:.1%} of detections".format(
        1 - ref["agree"]))
    phase_s["fbnet"] = time.perf_counter() - t0
    return sites, phase_s


TTA_SIZES = ((480, 640),) * 4 + ((640, 480),) * 4


def tta_demo_phase(torch, np, card, dl):
    """37-40. On phase 24's trees and weight cache (dl: the data-layer phases'
    work tree, cache and helpers): 37, test-time augmentation from the
    published TTA file as written (18 passes an image) through inference in
    process on an 8-image val tree, the kernels at its largest and smallest
    pass, a known answer, float32 card against CPU, then test_net with TTA
    over the Faster R-CNN file; 38, COCODemo on the flagship (the cache's
    Detectron model_final) and on the keypoint file, the heatmap montage and
    the webcam loop; 39, eval_zoo on the caffe2 file with the gate passing
    and failing; 40, convert("poly") of phase 25's Cityscapes binary masks.
    Returns the kernel sites and the wall seconds by path."""
    import pickle

    from maskrcnn_tpu_torch import predictor as predictor_module
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.data.build import make_data_loader
    from maskrcnn_tpu_torch.data.datasets import CityScapesDataset
    from maskrcnn_tpu_torch.demo import COCODemo, webcam
    from maskrcnn_tpu_torch.engine import bbox_aug
    from maskrcnn_tpu_torch.engine.inference import inference
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.ops import nms
    from maskrcnn_tpu_torch.tools import eval_zoo, test_net
    from maskrcnn_tpu_torch.utils.checkpoint import DetectronCheckpointer
    from maskrcnn_tpu_torch.utils.maskops import trace_contours, trace_contours_plain

    sites, phase_s = {}, {}
    r50 = "catalog://ImageNetPretrained/MSRA/R-50"
    final = "catalog://Caffe2Detectron/COCO/35858933/e2e_mask_rcnn_R-50-FPN_1x"

    def cfg_of(yaml, opts=()):
        c = defaults.clone()
        c.merge_from_file(os.path.join(REPO, "configs", yaml))
        c.merge_from_list(list(opts))
        return c

    # 37. test-time augmentation: the published file as written
    t0 = dl.reset()
    dl.coco["val2017"], n_gt, ann = synthetic_coco(np, dl.work, "val2017", TTA_SIZES,
                                                   seed=SEED + 60)
    opts = ["MODEL.ROI_HEADS.SCORE_THRESH", "0.0", "DATASETS.TEST", "('coco_2017_val',)"]
    cfg = cfg_of("test_time_aug/e2e_mask_rcnn_R_50_FPN_1x.yaml", opts)
    passes = bbox_aug.tta_passes(cfg)
    check(cfg.TEST.BBOX_AUG.ENABLED and len(passes) == 18 and cfg.MODEL.WEIGHT == r50
          and cfg.MODEL.MASK_ON, "the TTA YAML reads {} passes".format(len(passes)))
    cfg.freeze()
    print("tta: configs/test_time_aug/e2e_mask_rcnn_R_50_FPN_1x.yaml as written ({} passes an "
          "image: {}), {} ({}, heads seeded), {}; inference(iou_types=('bbox',), "
          "bbox_aug_cfg=cfg) in process on a synthetic coco_2017_val of 4 images of 480x640 "
          "and 4 of 640x480 ({} instances)".format(len(passes), passes, r50, cfg.TPU.COMPUTE_DTYPE,
                                                   " ".join(opts), n_gt), flush=True)
    model = build_detection_model(cfg, device="cuda", seed=SEED + 61)
    DetectronCheckpointer(cfg, model, save_dir=os.path.join(dl.work, "tta")).load(
        cfg.MODEL.WEIGHT)
    timing = {"host": 0.0, "model": 0.0, "merge": 0.0}
    saved = bbox_aug.pass_input, bbox_aug.merge_passes, model.infer_forward

    def timed(key, fn, sync=False):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            timing[key] += time.perf_counter() - t
            return out
        return run

    bbox_aug.pass_input = timed("host", saved[0])
    bbox_aug.merge_passes = timed("merge", saved[1])
    model.infer_forward = timed("model", saved[2], sync=True)
    out = os.path.join(dl.work, "tta_out")
    try:
        (loader,) = make_data_loader(cfg, is_train=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        first, _ = inference(model, loader, "coco_2017_val", iou_types=("bbox",),
                             output_folder=out, bbox_aug_cfg=cfg)
        wall = time.perf_counter() - t1
    finally:
        bbox_aug.pass_input, bbox_aug.merge_passes = saved[:2]
        del model.infer_forward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = len(TTA_SIZES)
    dl.done("tta", t0, {"nms": 2 * len(passes), "roi_align": 2 * len(passes)}, n)
    t_checks = time.perf_counter()
    split = {"s_per_img": wall / n, "host_s_per_img": timing["host"] / n,
             "model_s_per_img": timing["model"] / n, "merge_s_per_img": timing["merge"] / n,
             "rest_s_per_img": (wall - sum(timing.values())) / n}
    with open(os.path.join(out, "predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    check(len(preds) == n and all(0 < len(p) <= cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
                                  and set(p.fields()) == {"scores", "labels"}
                                  and np.isfinite(p.bbox).all() for p in preds),
          "tta predictions {}".format([len(p) for p in preds]))
    print("tta: {} images, launches per image NMS {} and ROIAlign forward {}; {} [{}]; "
          "peak memory {:.3f} GB; bbox AP {:.4f}".format(
              n, dl.launches["tta"]["nms"] // n, dl.launches["tta"]["roi_align"] // n,
              json.dumps(split), card, peak_gb, first.results["bbox"]["AP"]), flush=True)

    # the kernels at the largest and the smallest pass, against their plain versions
    found = {"nms": [], "roi_align": []}
    img = dl.coco["val2017"][1]
    for scale in (max(cfg.TEST.BBOX_AUG.SCALES), min(cfg.TEST.BBOX_AUG.SCALES)):
        padded, _ = bbox_aug.pass_input(img, scale, cfg.TEST.BBOX_AUG.MAX_SIZE, cfg)
        with Capture([rpn, box_head], "batched_nms") as nc, \
                Capture([detector], "multilevel_roi_align") as rc:
            bbox_aug.im_detect_bbox(model, [img], scale, cfg.TEST.BBOX_AUG.MAX_SIZE, cfg)
        check(len(nc.calls) == 2 and len(rc.calls) == 2, "tta pass {}: {} NMS, {} ROIAlign calls"
              .format(scale, len(nc.calls), len(rc.calls)))
        with torch.inference_mode():
            found["nms"] += [nms_site(torch, nms, *c, plain_iters=3) for c in nc.calls]
            found["roi_align"] += [roi_site(torch, poolers, *c) for c in rc.calls]
        for name, ss in found.items():
            for s_ in ss[-2:]:
                print("tta kernel site {} at scale {} (padded {}x{}) [{}]: {}".format(
                    name, scale, padded.shape[1], padded.shape[2], card, json.dumps(s_)),
                      flush=True)
    sites["tta"] = kernel_path_sites(**found)

    # a known answer: the first pass's detections as the gt of a second pass
    # on the first TTA_KNOWN_IMAGES of the images (each takes 18 passes)
    with open(ann) as f:
        tree = f.read()
    infos = json.loads(tree)["images"][:TTA_KNOWN_IMAGES]
    gts = detections_as_gt(preds, infos)
    write_coco_json(ann, infos, gts, range(1, 81))
    (loader,) = make_data_loader(cfg, is_train=False)
    second, _ = inference(model, loader, "coco_2017_val", iou_types=("bbox",),
                          output_folder=None, bbox_aug_cfg=cfg)
    with open(ann, "w") as f:  # every image again, for test_net below
        f.write(tree)
    known = {"gt_from_detections": len(gts), "AP50": second.results["bbox"]["AP50"],
             "AP": second.results["bbox"]["AP"]}
    print("tta known answer (the first pass's merged detections as gt) [{}]: {}".format(
        card, json.dumps(known)), flush=True)
    check(known["AP50"] >= 0.99, "TTA known-answer AP50 {}".format(known["AP50"]))

    # float32, card against CPU, one small image at reduced scales
    c32 = cfg.clone()
    c32.defrost()
    c32.TPU.COMPUTE_DTYPE = "float32"
    c32.INPUT.MIN_SIZE_TEST, c32.INPUT.MAX_SIZE_TEST = 160, 267
    c32.TEST.BBOX_AUG.SCALES, c32.TEST.BBOX_AUG.MAX_SIZE = (192,), 320
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    small = np.random.RandomState(SEED + 62).randint(0, 256, (240, 320, 3)).astype(np.uint8)
    state = model.state_dict()
    merged = []
    try:
        for dev in ("cuda", "cpu"):
            m = detector.GeneralizedRCNN(c32)
            m.load_state_dict(state)
            merged.append(bbox_aug.im_detect_bbox_aug(m.to(dev).eval(), [small], c32)[0])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    agree = match_detections(merged[0], merged[1])
    print("tta float32 card vs CPU on a 240x320 image, passes {} [{}]: {} and {} detections, "
          "{:.1%} with a partner".format(bbox_aug.tta_passes(c32), card, len(merged[0]),
                                         len(merged[1]), agree), flush=True)
    check(len(merged[0]) > 0 and agree >= 0.9, "TTA card and CPU disagree on {:.1%}".format(
        1 - agree))
    del model, state, m
    torch.cuda.empty_cache()
    phase_s["tta_checks"] = time.perf_counter() - t_checks

    # test_net with TTA switched on over the Faster R-CNN file
    t0 = dl.reset()
    tta_opts = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
                "TEST.BBOX_AUG.SCALES", "(400, 600, 1000)", "TEST.BBOX_AUG.MAX_SIZE", "2000",
                "TEST.BBOX_AUG.SCALE_H_FLIP", "True"]
    faster_opts = opts + tta_opts + ["OUTPUT_DIR", os.path.join(dl.work, "tta_test_net")]
    (res, _), = test_net.main(["--config-file", os.path.join(REPO, "configs",
                                                             "e2e_faster_rcnn_R_50_FPN_1x.yaml")]
                              + faster_opts)
    dl.done("tta_test_net", t0, {"nms": 16, "roi_align": 8}, n)
    check(set(res.results) == {"bbox"}, "test_net with TTA evaluated {}".format(set(res.results)))
    print("tta test_net --config-file configs/e2e_faster_rcnn_R_50_FPN_1x.yaml {} [{}]: bbox "
          "{}".format(" ".join(faster_opts[:-1]), card, json.dumps(dict(res.results["bbox"]))),
          flush=True)

    # 38. the demo: COCODemo on the flagship and on the keypoint file
    t0 = dl.reset()
    rs = np.random.RandomState(SEED + 63)
    image = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    demo_cfg = cfg_of("e2e_mask_rcnn_R_50_FPN_1x.yaml", [
        "MODEL.WEIGHT", final, "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
        "OUTPUT_DIR", os.path.join(dl.work, "demo")])
    demo = COCODemo(demo_cfg, min_image_size=800)
    requests = 1
    preds = demo.compute_prediction(image)  # warm-up
    scores = np.sort(np.asarray(preds.get_field("scores")))
    demo.confidence_threshold = float(scores[-21]) if len(scores) > 20 else 0.0
    with Capture([predictor_module], "paste_masks_in_image") as pc:
        t1 = time.perf_counter()
        preds = demo.compute_prediction(image)
        predict_ms = (time.perf_counter() - t1) * 1e3
        requests += 1
    top = demo.select_top_predictions(preds)
    t1 = time.perf_counter()
    drawn = demo.draw(image, top)
    draw_ms = (time.perf_counter() - t1) * 1e3
    with torch.inference_mode():
        paste_ms = cuda_ms(torch, lambda: predictor_module.paste_masks_in_image(*pc.calls[0]), 10)
    check(drawn.shape == image.shape and drawn.dtype == np.uint8 and (drawn != image).any()
          and len(top) == min(20, len(scores)), "the demo drew {} of shape {}".format(
              len(top), drawn.shape))
    run_ms = []
    for _ in range(2):
        t1 = time.perf_counter()
        out_img = demo.run_on_opencv_image(image)
        run_ms.append((time.perf_counter() - t1) * 1e3)
        requests += 1
    check(np.array_equal(out_img, drawn), "run_on_opencv_image differs from its own drawing")
    heat = COCODemo(demo_cfg, show_mask_heatmaps=True, min_image_size=800, model=demo.model,
                    confidence_threshold=demo.confidence_threshold)
    montage = heat.run_on_opencv_image(image)
    requests += 1
    check(montage.shape == image.shape and montage.dtype == np.uint8,
          "montage {} {}".format(montage.shape, montage.dtype))
    frames = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(3)]
    shown = []
    webcam.run(demo, frames, lambda img, s: shown.append((img.shape, img.dtype, s)))
    requests += 3
    check(len(shown) == 3 and all(s[0] == (480, 640, 3) and s[1] == np.uint8 for s in shown),
          "webcam loop {}".format(shown))
    del demo, heat
    kp_cfg = cfg_of("e2e_keypoint_rcnn_R_50_FPN_1x.yaml", [
        "MODEL.ROI_HEADS.SCORE_THRESH", "0.0", "OUTPUT_DIR", os.path.join(dl.work, "demo_kp")])
    check(kp_cfg.MODEL.WEIGHT == r50, "the keypoint YAML reads {}".format(kp_cfg.MODEL.WEIGHT))
    kp_demo = COCODemo(kp_cfg, confidence_threshold=0.0, min_image_size=800)
    kp_preds = kp_demo.compute_prediction(image)
    kp_img = kp_demo.draw(image, kp_demo.select_top_predictions(kp_preds))
    requests += 1
    joints = np.asarray(kp_preds.get_field("keypoints"))
    check(kp_img.shape == image.shape and kp_img.dtype == np.uint8 and joints.shape[1:] == (17, 4)
          and np.isfinite(joints).all(), "keypoint demo {} {}".format(kp_img.shape, joints.shape))
    dl.done("demo", t0, {"nms": 2, "roi_align": 2}, requests)
    latency = {"request_ms": predict_ms, "paste_ms": paste_ms, "model_ms": predict_ms - paste_ms,
               "drawing_ms": draw_ms, "run_on_opencv_image_ms": run_ms,
               "drawn_detections": len(top), "keypoint_detections": len(kp_preds),
               "joints_above_threshold": int((joints[..., 3] > 2.0).sum())}
    print("demo: COCODemo(configs/e2e_mask_rcnn_R_50_FPN_1x.yaml with {}, min_image_size 800) on "
          "480x640: {} -> image {} {}; heatmap montage {} {}; webcam loop over 3 frames; "
          "configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml drawn [{}]".format(
              final, json.dumps(latency), drawn.shape, drawn.dtype, montage.shape, montage.dtype,
              card), flush=True)
    del kp_demo
    torch.cuda.empty_cache()

    # 39. eval_zoo on the caffe2 file: its model_final from the cache, the tree given
    t0 = dl.reset()
    caffe2 = os.path.join(REPO, "configs", "caffe2", "e2e_mask_rcnn_R_50_FPN_1x_caffe2.yaml")
    zoo = ["--config-file", caffe2, "--ann-file", ann,
           "--img-dir", os.path.join(dl.work, "coco", "val2017"), "--output-dir"]
    rc_written = eval_zoo.main(zoo + [os.path.join(dl.work, "zoo_written"),
                                      "MODEL.ROI_HEADS.SCORE_THRESH", "0.0"])
    gate = "[['bbox', 'AP', 0.0, 0.1], ['segm', 'AP', 0.0, 0.1]]"
    rc_band = eval_zoo.main(zoo + [os.path.join(dl.work, "zoo_band"),
                                   "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
                                   "TEST.EXPECTED_RESULTS", gate])
    dl.done("eval_zoo", t0, {"nms": 2, "roi_align": 2}, 2)
    checks = [line for line in dl.logs.lines if "sanity check" in line]
    print("eval_zoo --config-file configs/caffe2/e2e_mask_rcnn_R_50_FPN_1x_caffe2.yaml "
          "--ann-file <the 8 images' json> --img-dir <coco/val2017> (its {} from the cache): "
          "exit {} with the published EXPECTED_RESULTS, exit {} with {} [{}]: {}".format(
              final, rc_written, rc_band, gate, card, json.dumps(checks)), flush=True)
    check(rc_written == 1 and rc_band == 0, "eval_zoo exits {} and {}".format(rc_written, rc_band))

    # 40. polygons from phase 25's Cityscapes binary masks
    t0 = time.perf_counter()
    val = CityScapesDataset(os.path.join(dl.work, "cityscapes", "leftImg8bit"),
                            os.path.join(dl.work, "cityscapes", "gtFine"), "val", "mask")
    trace_s, ious, rings, n_masks = 0.0, [], 0, 0
    for idx in range(len(val)):
        masks = val[idx][1].get_field("masks")
        t1 = time.perf_counter()
        polys = masks.convert("poly")
        trace_s += time.perf_counter() - t1
        n_masks += len(masks)
        rings += sum(len(inst.polygons) for inst in polys.instances.polygons)
        back = polys.convert("mask").get_mask_tensor().reshape(len(masks), *CITYSCAPES_HW)
        dense = masks.get_mask_tensor().reshape(len(masks), *CITYSCAPES_HW).astype(bool)
        inter = (back.astype(bool) & dense).sum((1, 2))
        union = (back.astype(bool) | dense).sum((1, 2))
        ious += (inter / np.maximum(union, 1)).tolist()
        if idx == 0:  # the plain twin on the first instances, cropped to their boxes
            for j, box in enumerate(val[idx][1].bbox[:3]):
                x0, y0, x1, y1 = (int(v) for v in box)
                crop = dense[j, max(y0 - 2, 0):y1 + 3, max(x0 - 2, 0):x1 + 3]
                check(all(np.array_equal(a, b) for a, b in zip(
                    trace_contours(crop), trace_contours_plain(crop))),
                      "the native and plain tracing differ on instance {}".format(j))
    poly = {"frames": len(val), "masks": n_masks, "rings": rings,
            "ms_per_mask": trace_s * 1e3 / max(n_masks, 1), "round_trip_iou_mean":
            float(np.mean(ious)), "round_trip_iou_min": float(np.min(ious))}
    print("polygons: convert('poly') of the Cityscapes val masks at 1024x2048, then back to "
          "masks [{}]: {}".format(card, json.dumps(poly)), flush=True)
    check(n_masks > 0 and rings >= n_masks and poly["round_trip_iou_min"] >= 0.8,
          "polygons {}".format(poly))
    phase_s["polygons"] = time.perf_counter() - t0
    return sites, phase_s

def synthetic_person_keypoints(np, path, n_images, seed, hw=(480, 640)):
    """A COCO person-keypoint annotation file for images 1..n_images of hw:
    1-4 persons an image (boxes of 80-300 x 150-450 px), 17 joints each,
    nine in ten inside the box and the rest up to 15 px outside it, each
    visible (2) with probability 0.7, labelled but hidden (1) with 0.15,
    else absent ((0, 0, 0)), and at least 10 visible joints an image."""
    rs = np.random.RandomState(seed)
    h, w = hw
    infos, anns = [], []
    for img_id in range(1, n_images + 1):
        infos.append({"id": img_id, "file_name": "{:06d}.jpg".format(img_id), "height": h,
                      "width": w})
        persons = []
        for _ in range(rs.randint(1, 5)):
            bw, bh = rs.uniform(80, 300), rs.uniform(150, 450)
            x0, y0 = rs.uniform(0, w - 1 - bw), rs.uniform(0, h - 1 - bh)
            xy = rs.uniform([x0, y0], [x0 + bw, y0 + bh], (17, 2))
            out = rs.rand(17) < 0.1
            xy[out] += rs.uniform(-15, 15, (int(out.sum()), 2))
            xy = np.clip(xy, 0, [w - 1, h - 1])
            v = rs.choice([2, 1, 0], 17, p=[0.7, 0.15, 0.15])
            persons.append((x0, y0, bw, bh, xy, v))
        if sum(int((p[5] > 0).sum()) for p in persons) < 10:
            persons[0][5][:10] = 2
        for x0, y0, bw, bh, xy, v in persons:
            kps = np.concatenate([np.round(xy, 2), v[:, None]], 1)
            kps[v == 0] = 0
            anns.append({"id": len(anns) + 1, "image_id": img_id, "iscrowd": 0,
                         "category_id": 1, "bbox": [float(x0), float(y0), float(bw), float(bh)],
                         "area": float(bw * bh), "keypoints": kps.ravel().tolist(),
                         "num_keypoints": int((v > 0).sum())})
    with open(path, "w") as f:
        json.dump({"images": infos, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return anns


def keypoints_as_gt(np, preds, infos, top):
    """COCO person-keypoint annotations of a test pass's detections
    (BoxLists on the original images, in the order of `infos`): each
    image's first `top` by score (the detections the keypoint evaluator
    reads), boxes with the +1 convention, every decoded joint visible."""
    anns = []
    for info, p in zip(infos, preds):
        kps = np.asarray(p.get_field("keypoints"))
        for i in np.argsort(-np.asarray(p.get_field("scores")), kind="stable")[:top]:
            x0, y0, x1, y1 = (float(v) for v in p.bbox[i])
            triplets = np.concatenate([kps[i, :, :2], np.full((kps.shape[1], 1), 2.0)], 1)
            anns.append({"id": len(anns) + 1, "image_id": info["id"], "iscrowd": 0,
                         "category_id": 1, "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                         "area": (x1 - x0 + 1) * (y1 - y0 + 1),
                         "keypoints": triplets.ravel().tolist(), "num_keypoints": kps.shape[1]})
    return anns


def keypoint_serving_check(torch, np, cfg, state, image, min_size):
    """One request in float32 through Predictor on the card (kernels) and on
    the CPU (plain versions), the same weights: each card detection's
    partner on the CPU (label exact, score within 1e-5, box within 1e-3
    px), and of the partners' joints the share within 1 px, the others
    listed."""
    from maskrcnn_tpu_torch.models import detector
    from maskrcnn_tpu_torch.predictor import Predictor

    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    c.MODEL.WEIGHT = ""
    torch.backends.cudnn.allow_tf32 = False
    outs = []
    for dev in ("cuda", "cpu"):
        m = detector.GeneralizedRCNN(c)
        m.load_state_dict(state)
        outs.append(Predictor(c, model=m.to(dev).eval(), device=dev,
                              min_image_size=min_size).compute_prediction(image))
    a, b = outs
    check(len(a["scores"]) == len(b["scores"]) > 0, "card kept {} detections, CPU {}".format(
        len(a["scores"]), len(b["scores"])))
    used, pairs = set(), []
    for i in range(len(a["scores"])):
        for j in range(len(b["scores"])):
            if (j not in used and a["labels"][i] == b["labels"][j]
                    and abs(a["scores"][i] - b["scores"][j]) <= 1e-5
                    and np.abs(a["boxes"][i] - b["boxes"][j]).max() <= 1e-3):
                used.add(j)
                pairs.append((i, j))
                break
    off = [np.abs(a["keypoints"][i, :, :2] - b["keypoints"][j, :, :2]).max(-1)
           for i, j in pairs]
    off = np.stack(off) if off else np.zeros((0, 17))
    far = [{"detection": int(pairs[d][0]), "joint": int(k), "px": float(off[d, k])}
           for d, k in zip(*np.nonzero(off > 1.0))]
    return {"detections": len(a["scores"]), "agree": len(pairs) / len(a["scores"]),
            "joints_within_1px": float((off <= 1.0).mean()) if off.size else 0.0,
            "joints_farther": far, "max_joint_px": float(off.max()) if off.size else None,
            "max_score_err": float(max(abs(a["scores"][i] - b["scores"][j]) for i, j in pairs))
            if pairs else None}


def keypoint_phase(torch, np, card, dl):
    """31. Keypoint R-CNN from configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml as
    written, on phase 24's images with person-keypoint annotations and its
    weight cache (dl: the data-layer phases' work tree and helpers):
    train_net for 3 iterations at batch 16, test_net with bbox and
    keypoints through the exact host decode and its known answer, and
    Predictor's requests with a float32 card-vs-CPU check. Returns the
    kernel sites by path."""
    import pickle

    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.data.datasets import COCODataset
    from maskrcnn_tpu_torch.data.evaluation.coco_eval import do_coco_evaluation
    from maskrcnn_tpu_torch.engine import inference
    from maskrcnn_tpu_torch.models import detector
    from maskrcnn_tpu_torch.predictor import Predictor
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils import profiling

    yaml = os.path.join(REPO, "configs", "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
    ann_dir = os.path.join(dl.work, "coco", "annotations")
    cfg = defaults.clone()
    cfg.merge_from_file(yaml)
    check(cfg.MODEL.KEYPOINT_ON and not cfg.MODEL.MASK_ON and cfg.SOLVER.IMS_PER_BATCH == 16
          and cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.INPUT.MAX_SIZE_TRAIN == 1333
          and cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS == (512,) * 8
          and cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50"
          and cfg.DATASETS.TRAIN == ("keypoints_coco_2014_train",
                                     "keypoints_coco_2014_valminusminival"),
          "the keypoint YAML reads {} on {}".format(cfg.MODEL.WEIGHT, cfg.DATASETS.TRAIN))
    n_train, n_val = len(dl.coco["train2014"]), len(dl.coco["val2014"])
    counts = [len(synthetic_person_keypoints(np, os.path.join(ann_dir, name), n, seed))
              for name, n, seed in (("person_keypoints_train2014.json", n_train, SEED + 13),
                                    ("person_keypoints_valminusminival2014.json", n_val,
                                     SEED + 14))]
    # the test split: the first KEYPOINT_TEST_IMAGES of the same images and
    # persons (the exact host decode's ~3 s an image bounds the test)
    n_test = KEYPOINT_TEST_IMAGES
    synthetic_person_keypoints(np, os.path.join(ann_dir, "person_keypoints_minival2014.json"),
                               n_test, SEED + 14)
    sites = {}

    # training as written: batch 16, 800x1333, bf16, 8 x 512 convs, 56x56 heatmaps
    t0 = dl.reset()
    out = os.path.join(dl.work, "keypoint")
    print("keypoint recipe: synthetic person-keypoint trees keypoints_coco_2014_train ({} "
          "images of 480x640, {} persons) and _valminusminival ({}, {}); train_net "
          "--config-file configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml --skip-test "
          "SOLVER.MAX_ITER 3 OUTPUT_DIR <dir> (its catalog:// R-50 from the cache)".format(
              n_train, counts[0], n_val, counts[1]), flush=True)
    torch.cuda.reset_peak_memory_stats()
    step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2}
    with dl.first_step(pooled=2) as caps:
        _, meters = train_net.main(["--config-file", yaml, "--skip-test",
                                    "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out])
        dl.done("keypoint_recipe", t0, step, 3)
    peak_run_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(dl.record["dataset"]) == n_train + n_val,
          "the keypoint training dataset has {} images".format(len(dl.record["dataset"])))
    n_loaded, n_total = dl.loaded_count()
    summary = dl.train_summary(meters, yaml, n_losses=5)
    check(all("loss_kp" in it for it in summary["losses_each"]), "no keypoint loss")
    kp_call = caps["roi_align"].calls[1]
    check(tuple(kp_call[1].shape) == (16 * cfg.TPU.KEYPOINT_ROI_CAP, 4)
          and kp_call[3].output_size == 14 and len(kp_call[0]) == 4,
          "the keypoint pooler took {} ROIs at P={}".format(tuple(kp_call[1].shape),
                                                            kp_call[3].output_size))
    del kp_call
    sites["keypoint_recipe"], _ = dl.step_sites("keypoint recipe", caps, 16, (80, 2000),
                                                pooled=2)
    del caps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = profiling.profile_steps(dl.record["step"], dl.record["batch"], steps=1)
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    print("keypoint recipe: loaded {}/{} tensors from R-50.pkl; 3 iterations at batch 16: {}; "
          "peak memory {:.3f} GB a step ({:.3f} GB over the run, the first step's inputs "
          "kept) [{}]".format(n_loaded, n_total, json.dumps(summary), peak_step_gb, peak_run_gb,
                              card), flush=True)
    print("keypoint step, torch.profiler [{}]: {}".format(card, json.dumps(
        {k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share", "top_kernels_ms")})),
        flush=True)
    dl.record.clear()

    # test_net on keypoints_coco_2014_minival: bbox and keypoints, the exact
    # host decode timed; then the known answer
    decode = {"s": 0.0, "rois": 0, "calls": 0}
    exact = inference.heatmaps_to_keypoints_exact

    def timed_decode(maps, rois):
        t1 = time.perf_counter()
        got = exact(maps, rois)
        decode["s"] += time.perf_counter() - t1
        decode["rois"] += len(rois)
        decode["calls"] += 1
        return got

    test_out = os.path.join(out, "test")
    t0 = dl.reset()
    inference.heatmaps_to_keypoints_exact = timed_decode
    try:
        ((res, _),) = test_net.main(["--config-file", yaml, "--ckpt",
                                     os.path.join(out, "model_final.pth"),
                                     "MODEL.ROI_HEADS.SCORE_THRESH", "0.0",
                                     "OUTPUT_DIR", test_out])
        dl.done("keypoint_test", t0, {"nms": 2, "roi_align": 2}, 1)
    finally:
        inference.heatmaps_to_keypoints_exact = exact
    check(set(res.results) == {"bbox", "keypoints"} and decode["calls"] == n_test,
          "keypoint test evaluated {} and decoded {} images".format(set(res.results),
                                                                    decode["calls"]))
    print("keypoint test_net on {} images at TEST.IMS_PER_BATCH 8 (SCORE_THRESH 0 for random "
          "heads): the exact host decode {:.4f} s an image ({} ROIs, {:.2f} ms a ROI) [{}]; "
          "{}".format(n_test, decode["s"] / n_test, decode["rois"],
                      decode["s"] * 1e3 / max(decode["rois"], 1), card,
                      json.dumps({k: dict(v) for k, v in res.results.items()})), flush=True)
    with open(os.path.join(test_out, "inference", "keypoints_coco_2014_minival",
                           "predictions.pkl"), "rb") as f:
        preds = pickle.load(f)
    with open(os.path.join(ann_dir, "person_keypoints_minival2014.json")) as f:
        infos = json.load(f)["images"]
    gts = keypoints_as_gt(np, preds, infos, top=20)
    write_coco_json(os.path.join(ann_dir, "person_keypoints_minival2014.json"), infos, gts, [1])
    known_ds = COCODataset(os.path.join(ann_dir, "person_keypoints_minival2014.json"),
                           os.path.join(dl.work, "coco", "val2014"))
    known, _ = do_coco_evaluation(known_ds, preds, False, None, ["bbox", "keypoints"], (), 4)
    known = {"keypoints_first_pass": dict(res.results["keypoints"]), "gt_from_detections":
             len(gts), "keypoints_known_answer": dict(known.results["keypoints"])}
    print("keypoint known answer (each image's first 20 detections and their decoded joints "
          "as gt) [{}]: {}".format(card, json.dumps(known)), flush=True)
    check(known["keypoints_known_answer"]["AP50"] >= 0.99, "keypoint known-answer AP50 {}".format(
        known["keypoints_known_answer"]["AP50"]))

    # serving: Predictor from the YAML (the cache's R-50.pkl), then float32
    # card against CPU with the heads redrawn so that scores and heatmaps spread
    dl.reset()
    scfg = cfg.clone()
    scfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    pred = Predictor(scfg, device="cuda", seed=SEED + 15, min_image_size=scfg.INPUT.MIN_SIZE_TEST)
    n_loaded, n_total = dl.loaded_count()
    rs = np.random.RandomState(SEED + 16)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUEST_SIZES]
    pred.compute_prediction(warm)
    t0 = dl.reset()
    latencies, outs = [], []
    for img in images:
        t1 = time.perf_counter()
        outs.append(pred.compute_prediction(img))
        latencies.append((time.perf_counter() - t1) * 1e3)
    dl.done("keypoint_serving", t0, {"nms": 2, "roi_align": 2}, len(images))
    for img, o in zip(images, outs):
        n, (h, w) = len(o["scores"]), img.shape[:2]
        check(set(o) == {"boxes", "scores", "labels", "keypoints"}
              and 0 < n <= scfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
              and o["keypoints"].shape == (n, 17, 4) and np.isfinite(o["keypoints"]).all()
              and (o["keypoints"][..., 0] <= w * 1.001).all()
              and (o["keypoints"][..., 1] <= h * 1.001).all() and (o["keypoints"] >= -1e-3)[
                  ..., :2].all() and (o["labels"] == 1).all(),
              "keypoint request {}x{}: {}".format(h, w, {k: v.shape for k, v in o.items()}))
    print("keypoint serving: configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml (bf16, SCORE_THRESH 0) "
          "from the cache's R-50.pkl (loaded {}/{} tensors), keypoints [N, 17, 4] on the "
          "original image; latency ms per request {} {} [{}]".format(
              n_loaded, n_total, json.dumps(REQUEST_SIZES), json.dumps(latencies), card),
          flush=True)
    state = {k: v.detach().cpu().clone() for k, v in pred.model.state_dict().items()}
    del pred, outs
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED + 17)
    for k, v in state.items():
        if k.endswith(".weight") and k.startswith(("roi_heads.keypoint.",
                                                   "roi_heads.box.predictor.cls_score")):
            if "kps_score_lowres" in k:  # each output sees in x 2 x 2 taps
                gain, fan_in = 10.0, v.shape[0] * 4
            else:
                gain, fan_in = (10.0 if "cls_score" in k else 2 ** 0.5), v[0].numel()
            v.copy_(torch.randn(v.shape, generator=gen) * gain / fan_in ** 0.5)
    ref = keypoint_serving_check(torch, np, scfg, state, images[0], min_size=480)
    print("keypoint float32 card vs CPU on a 480x640 request [{}]: {}".format(
        card, json.dumps(ref)), flush=True)
    check(ref["agree"] >= 0.9, "keypoints: card and CPU disagree on {:.1%} of detections".format(
        1 - ref["agree"]))
    check(ref["joints_within_1px"] >= 0.99, "keypoints: {:.2%} of the joints within 1 px".format(
        ref["joints_within_1px"]))
    return sites


def reference_check(torch, np, detector, cfg, state, images=None, image_sizes=None,
                    tol=(1e-4, 1e-2, 1e-3), report_tols=()):
    """The model's weights in float32 on a small batch: the card (kernels)
    against the CPU (plain versions), each side's padded detections turned
    into per-image BoxLists by engine.inference.detections_to_boxlists.
    images [B, H, W, 3] uint8 and image_sizes [B, 2]: by default one random
    image of 250x310 padded to 256x320. tol: the score, box (px) and mask
    tolerances of match_detections for "agree" (the least over the
    images); report_tols: more tolerances to report the agreement at."""
    from maskrcnn_tpu_torch.engine.inference import detections_to_boxlists

    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    if images is None:
        rs = np.random.RandomState(SEED + 1)
        images = rs.randint(0, 256, (1, 256, 320, 3)).astype(np.uint8)
        image_sizes = np.asarray([[250, 310]], np.int32)
    batch = {"images": torch.from_numpy(images), "image_sizes": torch.from_numpy(image_sizes)}
    outs, feats = [], []
    for dev in ("cuda", "cpu"):
        m = detector.GeneralizedRCNN(c)
        m.load_state_dict(state)
        m.to(dev).eval()
        b = {k: v.to(dev) for k, v in batch.items()}
        det = m.infer_forward(b)
        with torch.no_grad():
            x = m._prepare_images(b["images"], b["image_sizes"]).permute(0, 3, 1, 2)
            feats.append([f.cpu() for f in m.backbone(x.contiguous(memory_format=torch.channels_last))])
        outs.append(detections_to_boxlists({k: v.cpu() for k, v in det.items()}, image_sizes))
    counts = [[len(bl) for bl in out] for out in outs]
    check(counts[0] == counts[1] and min(counts[0]) > 0,
          "card kept {} detections, CPU {}".format(*counts))
    return {
        "detections": counts[0], "tolerances": list(tol),
        "agree": min(match_detections(a, b, *tol) for a, b in zip(*outs)),
        "agree_at": {"{}/{}/{}".format(*t): [match_detections(a, b, *t) for a, b in zip(*outs)]
                     for t in report_tols},
        "feature_rel_err": max(((a - b).abs().max() / b.abs().max()).item()
                               for a, b in zip(*feats)),
        "sorted_score_err": max(float(np.abs(np.sort(a.get_field("scores"))
                                             - np.sort(b.get_field("scores"))).max())
                                for a, b in zip(*outs)),
    }


# Gradients held card against CPU: the RPN head, P2's lateral and output
# convs (every ROI of a 64x96 image pools from P2), the box and mask heads.
# Deeper backbone weights are left out: at this image size their gradient
# reaches them only through the FPN's top-down sums of P2's, which largely
# cancel, so its rounding between card and CPU is magnified (PERF.md).
REF_GRADS = (
    "rpn.cls_logits.weight", "rpn.bbox_pred.weight", "rpn.conv.weight",
    "backbone.fpn.inner.0.conv.weight", "backbone.fpn.layer.0.conv.weight",
    "roi_heads.box.feature_extractor.fc6.weight", "roi_heads.box.predictor.cls_score.weight",
    "roi_heads.mask.predictor.conv5_mask.weight",
    "roi_heads.mask.predictor.mask_fcn_logits.weight",
)


def train_reference_check(torch, np, cfg, state, backwards):
    """One float32 forward and backward of the training losses on a small
    batch (2 images of 64x96) with the trained weights, on the card
    (kernels) and on the CPU (plain versions), with the same sampler draws.

    The discrete steps of the path would round apart on the two sides: the
    card and the CPU compute the objectness scores ~1e-6 apart, enough to
    swap near-equal proposals, and the proposals' ranks decide the greedy
    NMS order, the top-k cuts and which draw each proposal gets. So this
    check removes every rank-dependent decision while running the same
    code: the RPN box deltas are zeroed (the proposals are the anchors
    exactly), the NMS threshold is 1.0 (nothing is suppressed), no top-k
    cuts (pre- and post-NMS caps of the largest level's anchor count, a
    batch-wide cap of every anchor), and the box sampler takes every
    anchor and gt of an image (BATCH_SIZE_PER_IMAGE = anchors + gt slots,
    and as many mask ROIs), so every proposal is sampled whatever its rank.
    The matcher, NMS and
    ROIAlign kernels all run on the card side. The CPU side runs with
    oneDNN off: at these shapes its float32 convolutions lose percents of
    the gradient reaching P2 against a float64 run, PyTorch's own CPU
    convolutions about 1e-4 (PERF.md). Losses must agree to 1e-4 relative
    and the gradients in REF_GRADS to 1e-2 of their max (float32 sums over
    thousands of ROIs that largely cancel; PERF.md has the measured
    errors)."""
    from maskrcnn_tpu_torch.models import detector
    from maskrcnn_tpu_torch.ops.sampler import uniform_draws
    from maskrcnn_tpu_torch.tools.profile_train import train_batch

    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = train_batch(2, (64, 96), (64, 96), 8, c.TPU.GT_MASK_SIZE, SEED + 1,
                        "cpu", block_masks=True)
    b, g = batch["gt_labels"].shape
    with torch.no_grad():
        per_level = [a.shape[0] for a in detector.GeneralizedRCNN(c)._backbone(batch)[1]]
    n = sum(per_level)
    r = c.MODEL.RPN
    r.PRE_NMS_TOP_N_TRAIN = r.POST_NMS_TOP_N_TRAIN = max(per_level)
    r.FPN_POST_NMS_TOP_N_TRAIN = b * n
    r.NMS_THRESH = 1.0
    c.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = c.TPU.MASK_ROI_CAP = n + g
    n_props = min(b * n, len(per_level) * max(per_level)) + g
    state = {k: v.detach().cpu() for k, v in state.items()}
    state["rpn.bbox_pred.weight"] = torch.zeros_like(state["rpn.bbox_pred.weight"])
    state["rpn.bbox_pred.bias"] = torch.zeros_like(state["rpn.bbox_pred.bias"])
    gen = torch.Generator().manual_seed(SEED)
    draws = {}
    draws["rpn_pos"], draws["rpn_neg"] = uniform_draws((b, n), gen, "cpu")
    draws["box_pos"], draws["box_neg"] = uniform_draws((b, n_props), gen, "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        m = detector.GeneralizedRCNN(c)
        m.load_state_dict(state)
        m.to(dev)
        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = dev != "cpu"
        try:
            losses = m.train_forward({k: v.to(dev) for k, v in batch.items()},
                                     draws={k: v.to(dev) for k, v in draws.items()})
            sum(losses.values()).backward()
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        out[dev] = ({k: v.item() for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in m.named_parameters() if n in REF_GRADS})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    loss_err = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    grad_err = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gp}
    ref = {"backwards": backwards, "losses_card": lc, "losses_cpu": lp,
           "loss_rel_err": loss_err, "grad_rel_err": grad_err}
    print("float32 training step, card vs CPU: " + json.dumps(ref), flush=True)
    check(len(grad_err) == len(REF_GRADS), "missing gradients")
    check(all(v <= 1e-4 for v in loss_err.values()), "card and CPU losses differ")
    check(all(v <= 1e-2 for v in grad_err.values()), "card and CPU gradients differ")


def keep_tree(keep, work, weights, trees, opts=None):
    """Copy a phase's synthetic COCO tree (annotations and split folders),
    its images (pickled, by split and image id) and its weights to `keep`,
    where the multi-card phases' processes read them; with the options of
    a test_net run that reads them."""
    import pickle

    shutil.copytree(os.path.join(work, "coco"), os.path.join(keep, "coco"), dirs_exist_ok=True)
    shutil.copy(weights, os.path.join(keep, "weights.pth"))
    with open(os.path.join(keep, "images.pkl"), "wb") as f:
        pickle.dump(trees, f)
    if opts is not None:
        with open(os.path.join(keep, "opts.json"), "w") as f:
            json.dump(opts, f)


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(phases, world, work, timeout, env=None):
    """Run this script's multi-card `phases` (comma-separated) in `world`
    worker processes on the card (python3 chip_smoke.py --worker ...): one
    rank each, their logs in `work`. Returns each rank's results; fails,
    after stopping every rank, as soon as one fails or at `timeout`."""
    port = str(free_port())
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(work, "rank{}.log".format(rank)), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", phases, str(rank), str(world),
             port, work], stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, **(env or {}))))
    deadline = time.time() + timeout
    try:
        while True:
            states = [p.poll() for p in procs]
            if None not in states or any(s not in (None, 0) for s in states) \
                    or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    tails = []
    for rank, p in enumerate(procs):
        with open(os.path.join(work, "rank{}.log".format(rank))) as f:
            tails.append(f.read()[-3000:])
    for rank, p in enumerate(procs):
        check(p.returncode == 0, "multi-card phases {}: rank {} of {} ended with {}{}:\n{}".format(
            phases, rank, world, p.returncode,
            " (stopped at the time limit)" if time.time() > deadline else "",
            "\n".join("--- rank {} ---\n{}".format(r, t) for r, t in enumerate(tails))))
    results = []
    for rank in range(world):
        with open(os.path.join(work, "rank{}.json".format(rank))) as f:
            results.append(json.load(f))
    return results


def proposal_slots(cfg, per_level, gt_slots):
    """The training proposals of an image (select_proposals' output, the
    gt appended) for levels of `per_level` anchors."""
    r = cfg.MODEL.RPN
    k_post = min(r.POST_NMS_TOP_N_TRAIN, max(min(r.PRE_NMS_TOP_N_TRAIN, n) for n in per_level))
    n = len(per_level) * k_post
    return (min(r.FPN_POST_NMS_TOP_N_TRAIN, n) if len(per_level) > 1 else n) + gt_slots


def multi_card_phase(torch, np, card, keep):
    """20-23. The multi-card path on the one card: two ranks of a gloo group
    (this script's workers), a float32 step against one process, the
    flagship's bf16 steps at global batch 8 with the kernels at the
    per-rank shapes, train_net and test_net under two ranks; then NCCL at
    world size 1 through train_net."""
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model
    from maskrcnn_tpu_torch.ops.sampler import uniform_draws
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.tools.profile_train import train_batch

    work = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    try:
        # 20. the one-process float32 step the two ranks are held to
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = flagship_cfg()
        cfg.TPU.COMPUTE_DTYPE = "float32"
        model = build_detection_model(cfg, device="cuda", seed=SEED)
        batch = train_batch(2, F32_HW, F32_HW, cfg.TPU.MAX_GT_BOXES,
                            cfg.TPU.GT_MASK_SIZE, SEED + 3, "cuda", block_masks=True)
        batch["images"][1] *= 0.5  # the second image's scores at another scale
        calibrate_frozen_bn(torch, model, batch["images"])
        with torch.no_grad():  # spread objectness scores: few near-ties to round apart
            model.rpn.cls_logits.weight.mul_(20)
            model.rpn.cls_logits.bias.mul_(20)
            per_level = [a.shape[0] for a in model._backbone(batch)[1]]
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        draws = {}
        draws["rpn_pos"], draws["rpn_neg"] = uniform_draws((2, sum(per_level)), gen, "cuda")
        draws["box_pos"], draws["box_neg"] = uniform_draws(
            (2, proposal_slots(cfg, per_level, cfg.TPU.MAX_GT_BOXES)), gen, "cuda")
        opt = make_optimizer(cfg, model)
        metrics = make_train_step(model, opt, make_lr_scheduler(cfg, opt))(batch, draws=draws)
        # 41's bf16 reference: the same weights, batch and draws in the
        # flagship's dtype, the FPN features and one step's losses
        cfg16 = cfg.clone()
        cfg16.TPU.COMPUTE_DTYPE = "bfloat16"
        model16 = build_detection_model(cfg16, device="cuda", seed=SEED)
        model16.load_state_dict(state)
        with torch.no_grad():
            features16 = [f.cpu() for f in model16._backbone(batch)[0]]
        opt16 = make_optimizer(cfg16, model16)
        metrics16 = make_train_step(model16, opt16, make_lr_scheduler(cfg16, opt16))(
            batch, draws=draws)
        torch.save({"cfg": cfg._to_plain(), "state": state,
                    "batch": {k: v.cpu() for k, v in batch.items()},
                    "draws": {k: v.cpu() for k, v in draws.items()},
                    "losses": {k: v.item() for k, v in metrics.items()},
                    "after": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "cfg16": cfg16._to_plain(), "features16": features16,
                    "losses16": {k: v.item() for k, v in metrics16.items()}},
                   os.path.join(work, "f32_job.pt"))
        del model, opt, batch, draws, state, model16, opt16, features16
        # 21. the flagship with frozen-BN statistics from bench.py's batch of 8
        cfg = flagship_cfg()
        model = build_detection_model(cfg, device="cuda", seed=SEED)
        batch = train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                            cfg.TPU.GT_MASK_SIZE, SEED, "cuda")
        calibrate_frozen_bn(torch, model, batch["images"])
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   os.path.join(work, "bf16_state.pth"))
        del model, batch
        torch.cuda.empty_cache()
        # 22. train_net's flagship options (phase 13's, the default backward)
        base = config_opts(flagship_cfg(), defaults)
        with open(os.path.join(keep["eval"], "opts.json")) as f:
            eval_opts = json.load(f)
        job = {"root": keep["entry"], "images": os.path.join(keep["entry"], "images.pkl"),
               "opts": base + [
                   "MODEL.DEVICE", "cuda:0",
                   "MODEL.WEIGHT", os.path.join(keep["entry"], "weights.pth"),
                   "DATASETS.TRAIN", "('coco_2017_train',)", "SOLVER.IMS_PER_BATCH", "8",
                   "INPUT.MIN_SIZE_TRAIN", "(800,)", "INPUT.MAX_SIZE_TRAIN", "1333",
                   "SOLVER.CHECKPOINT_PERIOD", "4", "DATALOADER.NUM_WORKERS", "2",
                   "OUTPUT_DIR", os.path.join(work, "out")],
               "eval_root": keep["eval"], "eval_images": os.path.join(keep["eval"], "images.pkl"),
               # phase 18's batches of 8 on each rank: bf16 detections of random
               # weights move with a batch's make-up (at 4 a rank AP50 was 0.972)
               "eval_opts": ["--ckpt", os.path.join(keep["eval"], "weights.pth")] + eval_opts + [
                   "MODEL.DEVICE", "cuda:0", "DATALOADER.NUM_WORKERS", "2",
                   "TEST.IMS_PER_BATCH", str(MULTI_WORLD * EVAL_BATCH),
                   "OUTPUT_DIR", os.path.join(work, "known")],
               "nccl_out": os.path.join(work, "nccl_out")}
        with open(os.path.join(work, "entry_job.json"), "w") as f:
            json.dump(job, f)
        print("multi-card: two ranks of a gloo group on the one card (this script's workers), "
              "then NCCL at world size 1; the float32 one-process reference stepped: {}".format(
                  json.dumps({k: v.item() for k, v in metrics.items()})), flush=True)

        t0 = time.perf_counter()
        ranks = spawn_ranks("f32,bf16,entry,tp_f32", MULTI_WORLD, work, 720)
        print("multi-card: phases 20-22 and 41 in {:.1f} s".format(time.perf_counter() - t0),
              flush=True)
        out = check_two_ranks(ranks, card)

        # 23. NCCL at world size 1 from a torchrun-style environment
        t0 = time.perf_counter()
        (nccl,) = spawn_ranks("nccl", 1, work, 300, env={
            "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(free_port())})
        nccl = nccl["nccl"]
        print("multi-card NCCL at world size 1 through train_net ({:.1f} s) [{}]: {}".format(
            time.perf_counter() - t0, card, json.dumps(nccl)), flush=True)
        check(nccl["backend"] == "nccl" and nccl["world"] == 1, "phase 23 ran {} at world {}"
              .format(nccl["backend"], nccl["world"]))
        per_step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2,
                    "roi_align_backward_rmw": 0, "roi_align_backward_chunk": 0}
        check(nccl["launches"] == {k: 2 * v for k, v in per_step.items()},
              "phase 23 launched {}".format(nccl["launches"]))
        check(all(math.isfinite(v) for v in nccl["losses"].values()) and nccl["losses"],
              "phase 23 losses {}".format(nccl["losses"]))

        # 42-43. the model axis: four ranks, (data 2, model 2)
        t0 = time.perf_counter()
        tp4 = spawn_ranks("tp_bf16,tp_entry", TP_WORLD, work, 900)
        four_s = time.perf_counter() - t0
        out["tensor_parallel"] = check_tensor_parallel(
            torch, [r["tp_f32"] for r in ranks], tp4, card, work)
        out["phase_s"] = {"tensor_parallel_41": max(r["seconds"]["tp_f32"] for r in ranks),
                          "tensor_parallel_42_43": four_s}
        print("multi-card: the model axis, phase 41 in {:.1f} s, phases 42-43 in {:.1f} s".format(
            *out["phase_s"].values()), flush=True)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_tensor_parallel(torch, f32, four, card, work):
    """The checks of phases 41-43 on the ranks' results; returns the
    model-axis path's launches (the four ranks' sum) and per-rank kernel
    sites."""
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.models import build_detection_model
    from maskrcnn_tpu_torch.utils.checkpoint import DetectronCheckpointer

    print("model axis (data 1, model 2), float32 step against one process [{}]: {}".format(
        card, json.dumps(f32)), flush=True)
    for rank, r in enumerate(f32):
        check(max(r["loss_rel_err"].values()) <= 1e-5, "phase 41 rank {}: losses off the "
              "one-process step's by {}".format(rank, r["loss_rel_err"]))
        check(r["param_err"] <= 2e-4 * r["param_step"], "phase 41 rank {}: gathered parameters "
              "off by {} > 2e-4 * max|step| {}".format(rank, r["param_err"], r["param_step"]))
        check(r["fc6_block"] == [512, 12544], "phase 41 rank {}: fc6's block {}".format(
            rank, r["fc6_block"]))
        check(r["replicated_equal_to_rank0"] and r["blocks_equal_across_data_group"],
              "phase 41 rank {}: replicated leaves differ from rank 0's".format(rank))
        # bf16: the same ops on the same whole weights as one process; a
        # weight, bias or block rounded or cast otherwise changes bits
        check(r["bf16"]["equal"], "phase 41 rank {}: bf16 features or losses differ from one "
              "process's {}".format(rank, r["bf16"]))
    ckpt = f32[0]["ckpt"]
    check(ckpt["equal_to_gathered"] and ckpt["err_to_one_process"] <= 2e-4 * f32[0]["param_step"]
          and ckpt["momentum_buffers"] > 0, "phase 41 checkpoint {}".format(ckpt))

    bf16 = [r["tp_bf16"] for r in four]
    per_step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2,
                "roi_align_backward_rmw": 0, "roi_align_backward_chunk": 0}
    for rank, r in enumerate(bf16):
        print("model axis (data 2, model 2) bf16 rank {} [{}]: {}".format(rank, card, json.dumps(
            {k: v for k, v in r.items() if k != "sites"})), flush=True)
        check(r["coords"] == [rank // 2, rank % 2], "rank {} at {}".format(rank, r["coords"]))
        check(r["launches"] == {k: MULTI_STEPS * v for k, v in per_step.items()},
              "phase 42 rank {} launched {} in {} steps".format(rank, r["launches"], MULTI_STEPS))
        check(all(math.isfinite(v) for m in r["losses"] for v in m.values()),
              "phase 42 rank {}: losses {}".format(rank, r["losses"]))
        check(r["replicated_equal_to_rank0"] and r["blocks_equal_across_data_group"],
              "phase 42 rank {}: replicated leaves or blocks differ".format(rank))
        sites = r["sites"]
        b = r["images"]
        check(sites["nms_sites"][0]["shape"] == [5 * b, 2000] and
              sites["matcher_sites"][0]["images"] == b and
              [(x["rois"], x["P"]) for x in sites["roi_sites"]] == [(512 * b, 7), (128 * b, 14)] and
              [(x["rois"], x["P"]) for x in sites["bwd_sites_roi"]] == [(512 * b, 7), (128 * b, 14)],
              "phase 42 rank {}: per-rank kernel sites {}".format(rank, {
                  k: [(x.get("shape"), x.get("rois"), x.get("P")) for x in v]
                  for k, v in sites.items()}))
        for k, v in sites.items():
            for site in v:
                print("model axis rank {} kernel site [{}]: {}".format(rank, card, json.dumps(
                    dict(site, rank=rank))), flush=True)
    if TP_BATCH != TRAIN_BATCH:
        print("model axis: phase 42's global batch cut from {} to {}".format(TRAIN_BATCH, TP_BATCH))

    entry = [r["tp_entry"] for r in four]
    print("model axis train_net and test_net under (data 2, model 2): " + json.dumps(entry),
          flush=True)
    check([e["saves"] for e in entry] == [["model_0000004.pth", "model_final.pth"]] + [[]] * 3,
          "phase 43 checkpoints written {}".format([e["saves"] for e in entry]))
    check(all(e["resumed"] and e["validated"] for e in entry),
          "phase 43: a rank did not resume from model_final or validate")
    check(entry[0]["iterations"] == [[4], [6]], "phase 43 rank 0 logged iterations {}".format(
        entry[0]["iterations"]))
    check(all(math.isfinite(v) for e in entry for v in e["losses"].values()),
          "phase 43 losses {}".format([e["losses"] for e in entry]))
    for e in entry:  # validation and the final test, then the known answer
        for shards, n in [(s, VAL_IMAGES) for s in e["train_gathered"]] + [
                (s, len(EVAL_SIZES)) for s in e["known_gathered"]]:
            check(sorted(i for s in shards for i in s) == list(range(n))
                  and not shards[1] and not shards[3],
                  "phase 43: the gathered predictions' images {}".format(shards))
    check(len(entry[0]["train_gathered"]) == 2, "phase 43 evaluated {} times in training"
          .format(len(entry[0]["train_gathered"])))
    check(all(e["known"] is None for e in entry[1:]), "ranks 1-3 returned results")
    check(entry[0]["known"]["bbox"]["AP50"] >= 0.99, "phase 43 known-answer bbox AP50 {} < 0.99 "
          "under the mesh".format(entry[0]["known"]["bbox"]["AP50"]))
    # the checkpoint read in one process equals the model the ranks gathered
    model = build_detection_model(flagship_cfg(), device="cpu", seed=SEED + 1)
    DetectronCheckpointer(flagship_cfg(), model).load(os.path.join(work, "tp_out",
                                                                   "model_final.pth"))
    gathered = torch.load(os.path.join(work, "tp_state.pth"), weights_only=True)
    check(set(gathered) == set(model.state_dict()) and all(
        torch.equal(v, gathered[k]) for k, v in model.state_dict().items()),
        "phase 43: model_final.pth read in one process differs from the gathered model")
    print("model axis: model_final.pth read in one process equals the ranks' gathered model",
          flush=True)

    out = {"launches": {k: sum(r["launches"][k] for r in bf16) for k in per_step}}
    for k in ("nms_sites", "roi_sites", "bwd_sites_roi", "matcher_sites"):
        out[k] = [dict(s, rank=rank) for rank, r in enumerate(bf16) for s in r["sites"][k]]
    return out


def check_two_ranks(ranks, card):
    """The checks of phases 20-22 on both ranks' results; returns the
    multi-card path's launches (both ranks' sum) and per-rank kernel sites."""
    f32 = [r["f32"] for r in ranks]
    print("multi-card float32 step, two ranks against one process: " + json.dumps(f32),
          flush=True)
    for rank, r in enumerate(f32):
        check(max(r["loss_rel_err"].values()) <= 1e-5, "rank {}: losses off the one-process "
              "step's by {}".format(rank, r["loss_rel_err"]))
        check(r["param_err"] <= 2e-4 * r["param_step"], "rank {}: parameters off by {} > 2e-4 * "
              "max|step| {}".format(rank, r["param_err"], r["param_step"]))
        check(r["bitwise_equal_to_rank0"], "rank {}: parameters differ from rank 0's".format(rank))
        check(r["kept_global"] != r["kept_local"], "rank {}: the global FPN k-th score keeps {} "
              "proposals, its own k-th score as many".format(rank, r["kept_global"]))
    check(sum(r["kept_global"] for r in f32) == f32[0]["fpn_post"],
          "the global k-th score kept {}".format([r["kept_global"] for r in f32]))

    bf16 = [r["bf16"] for r in ranks]
    for rank, r in enumerate(bf16):
        print("multi-card bf16 rank {} [{}]: {}".format(rank, card, json.dumps(
            {k: v for k, v in r.items() if k != "sites"})), flush=True)
        per_step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2,
                    "roi_align_backward_rmw": 0, "roi_align_backward_chunk": 0}
        check(r["launches"] == {k: MULTI_STEPS * v for k, v in per_step.items()},
              "rank {} launched {} in {} steps".format(rank, r["launches"], MULTI_STEPS))
        check(all(math.isfinite(v) for m in r["losses"] for v in m.values()),
              "rank {}: losses {}".format(rank, r["losses"]))
        check(r["bitwise_equal_to_rank0"], "rank {}: bf16 parameters differ from rank 0's"
              .format(rank))
        sites = r["sites"]
        b = TRAIN_BATCH // MULTI_WORLD
        check(sites["nms_sites"][0]["shape"] == [5 * b, 2000] and
              sites["matcher_sites"][0]["images"] == b and
              [(x["rois"], x["P"]) for x in sites["roi_sites"]] == [(512 * b, 7), (128 * b, 14)] and
              [(x["rois"], x["P"]) for x in sites["bwd_sites_roi"]] == [(512 * b, 7), (128 * b, 14)],
              "rank {}: per-rank kernel sites {}".format(rank, {
                  k: [(x.get("shape"), x.get("rois"), x.get("P")) for x in v]
                  for k, v in sites.items()}))
        for k, v in sites.items():
            for site in v:
                print("multi-card rank {} kernel site [{}]: {}".format(rank, card, json.dumps(
                    dict(site, rank=rank))), flush=True)

    entry = [r["entry"] for r in ranks]
    print("multi-card train_net and test_net under two ranks: " + json.dumps(entry), flush=True)
    check(entry[0]["saves"] == ["model_0000004.pth", "model_final.pth"] and entry[1]["saves"] == [],
          "checkpoints written by rank 0 {}, by rank 1 {}".format(entry[0]["saves"],
                                                                 entry[1]["saves"]))
    check(all(e["resumed"] for e in entry), "a rank did not resume from model_final")
    check(entry[0]["iterations"] == [[4], [6]], "rank 0 logged iterations {}".format(
        entry[0]["iterations"]))
    for e, n in (("test_gathered", VAL_IMAGES), ("known_gathered", len(EVAL_SIZES))):
        shards = entry[0][e]
        check(sorted(i for s in shards for i in s) == list(range(n)),
              "the gathered predictions' images {}".format(shards))
    check(entry[0]["predictions"] == VAL_IMAGES, "predictions.pkl holds {} images".format(
        entry[0]["predictions"]))
    check(entry[1]["test"] is None and entry[1]["known"] is None, "rank 1 returned results")
    check(set(entry[0]["test"]) == {"bbox", "segm"}, "rank 0's test results {}".format(
        entry[0]["test"]))
    check(entry[0]["known"]["bbox"]["AP50"] >= 0.99, "known-answer bbox AP50 {} < 0.99 under two "
          "ranks".format(entry[0]["known"]["bbox"]["AP50"]))

    launches = {k: sum(r["launches"][k] for r in bf16) for k in bf16[0]["launches"]}
    out = {"launches": launches}
    for k in ("nms_sites", "roi_sites", "bwd_sites_roi", "matcher_sites"):
        out[k] = [dict(s, rank=rank) for rank, r in enumerate(bf16) for s in r["sites"][k]]
    return out


def _rank_params_equal(torch, model):
    """Whether this rank's parameters equal rank 0's bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    theirs = flat.clone()
    dist.broadcast(theirs, 0)
    return bool(torch.equal(flat, theirs))


def _kth(torch, scores, k):
    return float(torch.topk(scores.reshape(-1), min(k, scores.numel())).values[-1])


def worker_f32(torch, np, rank, world, work):
    """20. This rank's image of the float32 job's two, the global draws, one
    SGD step; against the one-process step; the FPN top-k's kept counts."""
    from maskrcnn_tpu_torch.config.cfgnode import CfgNode
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils import comm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(work, "f32_job.pt"), weights_only=False)
    cfg = CfgNode(job["cfg"])
    model = GeneralizedRCNN(cfg)
    model.load_state_dict(job["state"])
    model.cuda()
    b = job["batch"]["images"].shape[0] // world
    batch = {k: v[rank * b:(rank + 1) * b].cuda() for k, v in job["batch"].items()}
    draws = {k: v.cuda() for k, v in job["draws"].items()}
    seen = []
    gather_rows = comm.gather_rows
    comm.gather_rows = lambda t: seen.append(t.clone()) or gather_rows(t)
    try:
        opt = make_optimizer(cfg, model)
        metrics = make_train_step(model, opt, make_lr_scheduler(cfg, opt))(batch, draws=draws)
    finally:
        comm.gather_rows = gather_rows
    losses = {k: v.item() for k, v in metrics.items()}
    err, step = 0.0, 0.0
    for name, p in model.state_dict().items():
        want, before = job["after"][name].cuda(), job["state"][name].cuda()
        err = max(err, float((p - want).abs().max()))
        step = max(step, float((want - before).abs().max()))
    k = cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
    local = seen[0]
    gathered = gather_rows(local)
    count = lambda kth: int((local >= max(kth, -5e9)).sum())  # noqa: E731
    return {"losses": losses,
            "loss_rel_err": {kk: abs(v - job["losses"][kk]) / max(abs(job["losses"][kk]), 1e-12)
                             for kk, v in losses.items()},
            "param_err": err, "param_step": step,
            "bitwise_equal_to_rank0": _rank_params_equal(torch, model), "fpn_post": k,
            "kept_global": count(_kth(torch, gathered, k)), "kept_local": count(_kth(torch, local, k))}


def worker_bf16(torch, np, rank, world, work):
    """21. The flagship in bf16 at global batch 8: this rank's 4 images of
    bench.py's batch, MULTI_STEPS steps; launches, step times, the kernels
    at the per-rank shapes (rank by rank), the gradient all-reduce's and the
    gathered FPN top-k's times, and the ranks' parameters compared."""
    import torch.distributed as dist

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.engine.trainer import step_seed
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.parallel import reduce_gradients
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils import comm
    from maskrcnn_tpu_torch.tools.profile_train import train_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_cfg()
    model = build_detection_model(cfg, device="cuda", seed=SEED)
    model.load_state_dict(torch.load(os.path.join(work, "bf16_state.pth"), weights_only=True))
    full = train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                       cfg.TPU.GT_MASK_SIZE, SEED, "cpu")
    b = TRAIN_BATCH // world
    batch = {k: v[rank * b:(rank + 1) * b].cuda() for k, v in full.items()}
    del full
    opt = make_optimizer(cfg, model)
    gen = torch.Generator(device="cuda")
    step = make_train_step(model, opt, make_lr_scheduler(cfg, opt), generator=gen)
    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    seen = []
    gather_rows = comm.gather_rows
    comm.gather_rows = lambda t: (seen.append(t.clone()) if not seen else None) or gather_rows(t)
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        with Capture([rpn], "match_anchors_batched", limit=1) as match_cap, \
                Capture([rpn], "batched_nms", limit=1) as nms_cap, \
                Capture([detector], "multilevel_roi_align", grads=True, limit=2) as roi_cap:
            for i in range(MULTI_STEPS):
                gen.manual_seed(step_seed(i + 1))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append({k: v.item() for k, v in m.items()})
    finally:
        comm.gather_rows = gather_rows
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the gradient all-reduce (the last step's gradients) and the gathered
    # FPN top-k, both ranks in step
    n_grad = sum(p.grad.numel() for p in model.parameters() if p.grad is not None)
    allreduce = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(model)
        torch.cuda.synchronize()
        allreduce.append((time.perf_counter() - t0) * 1e3)
    k = cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
    topk = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _kth(torch, comm.gather_rows(seen[0]), k)
        topk.append((time.perf_counter() - t0) * 1e3)
    equal = _rank_params_equal(torch, model)
    opt.zero_grad(set_to_none=True)
    del opt, step
    torch.cuda.empty_cache()
    # the kernels at the per-rank shapes, one rank at a time
    sites = {}
    for turn in range(world):
        if turn == rank:
            sites["matcher_sites"] = [matcher_site(torch, matcher, *match_cap.calls[0])]
            with torch.no_grad():
                sites["nms_sites"] = [nms_site(torch, nms, *nms_cap.calls[0], plain_iters=3)]
                sites["roi_sites"] = [roi_site(torch, poolers, [f.detach() for f in c[0]], *c[1:])
                                      for c in roi_cap.calls]
            sites["bwd_sites_roi"] = [
                roi_backward_site(torch, poolers, [f.detach() for f in c[0]], *c[1:],
                                  roi_cap.out_grads[i], "roi")
                for i, c in enumerate(roi_cap.calls)]
            torch.cuda.empty_cache()
        dist.barrier()
    return {"launches": launches, "losses": losses, "step_ms": times,
            "gradient_values": n_grad, "gradient_mb": n_grad * 4 / 1e6,
            "allreduce_ms": allreduce, "gathered_topk_ms": topk,
            "topk_scores_per_rank": seen[0].numel(), "peak_memory_gb": peak_gb,
            "bitwise_equal_to_rank0": equal, "sites": sites}


def _override_images(job_images):
    """COCODataset hands over the phase's seeded arrays (no image decoder)."""
    import pickle

    from maskrcnn_tpu_torch.data.datasets import COCODataset

    with open(job_images, "rb") as f:
        trees = pickle.load(f)
    COCODataset._load_image = (
        lambda self, index: trees[os.path.basename(self.root)][self.ids[index]])


def worker_entry(torch, np, rank, world, work):
    """22. train_net in the group this worker made: 4 iterations (a
    checkpoint at 4), a resume to 6 with the final test on the val tree;
    then test_net on phase 18's known answer."""
    import pickle

    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils import comm

    with open(os.path.join(work, "entry_job.json")) as f:
        job = json.load(f)
    logs = LogLines()
    for name in ("maskrcnn_tpu_torch", "maskrcnn_tpu_torch.checkpointer"):
        logging.getLogger(name).addHandler(logs)
    gathered, returned = [], []
    all_gather, run_test = comm.all_gather, train_net.run_test

    def recording(data):
        out = all_gather(data)
        if isinstance(data, dict) and data and all(isinstance(k, int) for k in data):
            gathered.append([sorted(d) for d in out])  # inference's predictions by index
        return out

    def run_test_recording(cfg, model):
        returned.append(run_test(cfg, model))
        return returned[-1]

    comm.all_gather, train_net.run_test = recording, run_test_recording
    out_dir = job["opts"][job["opts"].index("OUTPUT_DIR") + 1]
    try:
        _override_images(job["images"])
        with environ(MASKRCNN_TPU_DATA_DIR=job["root"]):
            t0 = time.perf_counter()
            train_net.main(["--skip-test"] + job["opts"] + ["SOLVER.MAX_ITER", "4"])
            first_s = time.perf_counter() - t0
            first = list(logs.lines)
            logs.lines.clear()
            t0 = time.perf_counter()
            train_net.main(job["opts"] + ["SOLVER.MAX_ITER", "6", "DATASETS.TEST",
                                          "('coco_2017_val',)", "TEST.IMS_PER_BATCH", "8"])
            second_s = time.perf_counter() - t0
            second = list(logs.lines)
        test_gathered = gathered[-1]
        _override_images(job["eval_images"])
        with environ(MASKRCNN_TPU_DATA_DIR=job["eval_root"]):
            t0 = time.perf_counter()
            known = test_net.main(job["eval_opts"])
            known_s = time.perf_counter() - t0
    finally:
        comm.all_gather, train_net.run_test = all_gather, run_test
    pred_file = os.path.join(out_dir, "inference", "coco_2017_val", "predictions.pkl")
    n_pred = None
    if rank == 0:
        with open(pred_file, "rb") as f:
            n_pred = len(pickle.load(f))
    ((test, _),) = returned[-1] if rank == 0 else ((None, None),)
    return {"saves": [os.path.basename(line.split()[-1]) for line in first
                      if line.startswith("Saving checkpoint to")],
            "resumed": any(line == "Loading checkpoint from " + os.path.join(out_dir,
                                                                              "model_final.pth")
                           for line in second),
            "iterations": [[int(m) for line in lines for m in re.findall(r"iter: (\d+)", line)]
                           for lines in (first, second)],
            "test_gathered": test_gathered, "predictions": n_pred,
            "test": None if test is None else {k: dict(v) for k, v in test.results.items()},
            "known_gathered": gathered[-1],
            "known": None if known is None else {k: dict(v) for k, v in known[0][0].results.items()},
            "returned_on_rank": [r is not None for r in returned[-1]],
            "train_4_s": first_s, "resume_test_s": second_s, "known_test_s": known_s}


def worker_nccl(torch, np, rank, world, work):
    """23. train_net from a torchrun-style environment of one process: its
    init_distributed makes an NCCL group, and the step's reductions, the
    broadcast and the model's collectives run through it; then the
    gradient all-reduce and the broadcast timed alone."""
    import torch.distributed as dist

    from maskrcnn_tpu_torch.models import poolers
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.parallel import broadcast_parameters, reduce_gradients
    from maskrcnn_tpu_torch.tools import train_net
    from maskrcnn_tpu_torch.utils import comm

    with open(os.path.join(work, "entry_job.json")) as f:
        job = json.load(f)
    _override_images(job["images"])
    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    with environ(MASKRCNN_TPU_DATA_DIR=job["root"]):
        t0 = time.perf_counter()
        model, meters = train_net.main(["--skip-test"] + job["opts"] + [
            "SOLVER.MAX_ITER", "2", "MODEL.DEVICE", "cuda", "OUTPUT_DIR", job["nccl_out"]])
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    backend, world_size = dist.get_backend(), dist.get_world_size()
    n_grad = sum(p.grad.numel() for p in model.parameters() if p.grad is not None)
    timed = {"allreduce_ms": lambda: reduce_gradients(model),
             "broadcast_ms": lambda: broadcast_parameters(model),
             "global_sum_ms": lambda: comm.global_sum(torch.ones((), device="cuda"))}
    out = {k: cuda_ms(torch, fn, 10) for k, fn in timed.items()}
    out.update(backend=backend, world=world_size, launches=launches, wall_s=wall,
               gradient_values=n_grad, device=str(next(model.parameters()).device),
               losses={k: m.global_avg for k, m in meters.meters.items() if k.startswith("loss")})
    return out


def _mesh_cfg(cfg, shape):
    """`cfg` under ("data", "model") / `shape`, on cuda:0, the mesh laid out
    over this worker's group."""
    from maskrcnn_tpu_torch.parallel import init_distributed

    cfg.MODEL.DEVICE = "cuda:0"
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ("data", "model"), shape
    init_distributed(cfg)
    return cfg


def _equal_to(torch, tensors, src, group=None):
    """Whether these tensors equal the process `src`'s bit for bit (one
    broadcast of them flattened, over `group`)."""
    import torch.distributed as dist

    if not tensors:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    theirs = flat.clone()
    dist.broadcast(theirs, src, group=group)
    return bool(torch.equal(flat, theirs))


def _tp_equality(torch, model):
    """The replicated leaves against rank 0's, the sharded blocks against
    those of the data group's first process (the same model coordinate)."""
    from maskrcnn_tpu_torch.utils import comm

    params = list(model.parameters())
    mesh = comm.get_mesh()
    return {"replicated_equal_to_rank0": _equal_to(
                torch, [p for p in params if not hasattr(p, "model_dim")], 0),
            "blocks_equal_across_data_group": _equal_to(
                torch, [p for p in params if hasattr(p, "model_dim")], mesh.data_ranks[0],
                comm.data_group())}


def _tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _tp_bf16_against_one_process(torch, job, batch, draws):
    """41 in bf16: the sharded model's FPN features and one SGD step's
    losses on phase 20's batch, weights and draws against the one-process
    bf16 step's (job["features16"], job["losses16"]): their largest
    absolute differences, and whether they are equal bit for bit."""
    from maskrcnn_tpu_torch.config.cfgnode import CfgNode
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
    from maskrcnn_tpu_torch.parallel import shard_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    cfg = _mesh_cfg(CfgNode(job["cfg16"]), (-1, 2))
    model = GeneralizedRCNN(cfg)
    model.load_state_dict(job["state"])
    model.cuda()
    opt = make_optimizer(cfg, model)
    shard_model(model, opt)
    with torch.no_grad():
        features = [f.cpu() for f in model._backbone(batch)[0]]
    metrics = make_train_step(model, opt, make_lr_scheduler(cfg, opt))(batch, draws=draws)
    losses = {k: v.item() for k, v in metrics.items()}
    want = job["features16"]
    return {"feature_max_abs_err": [float((f.float() - w.float()).abs().max())
                                    for f, w in zip(features, want)],
            "feature_max_abs": [float(w.float().abs().max()) for w in want],
            "loss_abs_err": {k: abs(v - job["losses16"][k]) for k, v in losses.items()},
            "equal": all(torch.equal(f, w) for f, w in zip(features, want))
            and losses == job["losses16"]}


def worker_tp_f32(torch, np, rank, world, work):
    """41. Phase 20's job on a (data 1, model 2) mesh, both images on both
    ranks, the weights' output channels sharded: in bf16 the FPN features
    and one step's losses against one process's; in float32 one SGD step
    against the one-process step, fc6's block, the replicated leaves
    compared, a checkpoint written under the mesh by rank 0 and read
    back."""
    from maskrcnn_tpu_torch.config.cfgnode import CfgNode
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
    from maskrcnn_tpu_torch.parallel import gather_state, shard_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils.checkpoint import Checkpointer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(work, "f32_job.pt"), weights_only=False)
    batch = {k: v.cuda() for k, v in job["batch"].items()}
    draws = {k: v.cuda() for k, v in job["draws"].items()}
    bf16 = _tp_bf16_against_one_process(torch, job, batch, draws)
    torch.cuda.empty_cache()
    cfg = _mesh_cfg(CfgNode(job["cfg"]), (-1, 2))
    model = GeneralizedRCNN(cfg)
    model.load_state_dict(job["state"])
    model.cuda()
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    dims = shard_model(model, opt)
    fc6 = model.roi_heads.box.feature_extractor.fc6.weight
    metrics = make_train_step(model, opt, sched)(batch, draws=draws)
    losses = {k: v.item() for k, v in metrics.items()}
    state, _ = gather_state(model, opt)
    err, step = 0.0, 0.0
    for name, p in state.items():
        want, before = job["after"][name].cuda(), job["state"][name].cuda()
        err = max(err, float((p - want).abs().max()))
        step = max(step, float((want - before).abs().max()))
    out_dir = os.path.join(work, "tp_f32_ckpt")
    Checkpointer(model, opt, sched, out_dir).save("model_0000001", iteration=1)
    ckpt = {}
    if rank == 0:
        saved = torch.load(os.path.join(out_dir, "model_0000001.pth"), map_location="cpu",
                           weights_only=True)
        ckpt = {"equal_to_gathered": all(torch.equal(saved["model"][k], v.cpu())
                                         for k, v in state.items()),
                "err_to_one_process": max(float((v - job["after"][k]).abs().max())
                                          for k, v in saved["model"].items()),
                "momentum_buffers": len(saved["optimizer"]["state"])}
    return dict(_tp_equality(torch, model), losses=losses, ckpt=ckpt, bf16=bf16,
                loss_rel_err={k: abs(v - job["losses"][k]) / max(abs(job["losses"][k]), 1e-12)
                              for k, v in losses.items()},
                param_err=err, param_step=step, fc6_block=list(fc6.shape), sharded=len(dims))


def worker_tp_bf16(torch, np, rank, world, work):
    """42. The flagship in bf16 on a (data 2, model 2) mesh at global batch
    TP_BATCH: this data coordinate's images of bench.py's batch, MULTI_STEPS
    steps, the last with every collective timed (CUDA synchronized around
    it) and its bytes by group; launches, step times, the kernels at the
    per-rank shapes (rank by rank); the gradient all-reduce alone; the
    parameters' and the momentum's bytes; the ranks compared."""
    import torch.distributed as dist

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.engine.trainer import step_seed
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.parallel import reduce_gradients, shard_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils import comm
    from maskrcnn_tpu_torch.tools.profile_train import train_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _mesh_cfg(flagship_cfg(), (-1, 2))
    model = build_detection_model(cfg, device="cuda", seed=SEED)
    model.load_state_dict(torch.load(os.path.join(work, "bf16_state.pth"), weights_only=True))
    full_param_bytes = _tensor_bytes(list(model.parameters()))
    full = train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                       cfg.TPU.GT_MASK_SIZE, SEED, "cpu")
    b = TP_BATCH // comm.data_size()
    batch = {k: v[comm.data_rank() * b:(comm.data_rank() + 1) * b].cuda()
             for k, v in full.items()}
    del full
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    dims = shard_model(model, opt)
    gen = torch.Generator(device="cuda")
    step = make_train_step(model, opt, sched, generator=gen)
    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    # the last step with every collective timed between two synchronizations
    groups = {"model": comm.model_group(), "data": comm.data_group()}
    traffic = {g: {"calls": 0, "mb": 0.0, "ms": 0.0} for g in ("model", "data", "world")}
    originals = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def timed(fn):
        def wrapper(*args, group=None, **kwargs):
            kind = next((k for k, g in groups.items() if g is group and g is not None), "world")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, group=group, **kwargs)
            torch.cuda.synchronize()
            traffic[kind]["ms"] += (time.perf_counter() - t0) * 1e3
            traffic[kind]["calls"] += 1
            traffic[kind]["mb"] += _tensor_bytes([t for t in args if torch.is_tensor(t)][:1]) / 1e6
            return out
        return wrapper

    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    with Capture([rpn], "match_anchors_batched", limit=1) as match_cap, \
            Capture([rpn], "batched_nms", limit=1) as nms_cap, \
            Capture([detector], "multilevel_roi_align", grads=True, limit=2) as roi_cap:
        for i in range(MULTI_STEPS):
            gen.manual_seed(step_seed(i + 1))
            if i == MULTI_STEPS - 1:
                for name, fn in originals.items():
                    setattr(dist, name, timed(fn))
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
            finally:
                for name, fn in originals.items():
                    setattr(dist, name, fn)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: v.item() for k, v in m.items()})
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    allreduce = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(model)
        torch.cuda.synchronize()
        allreduce.append((time.perf_counter() - t0) * 1e3)
    momentum = [s["momentum_buffer"] for s in opt.state.values() if "momentum_buffer" in s]
    equal = _tp_equality(torch, model)
    opt.zero_grad(set_to_none=True)
    del opt, step
    torch.cuda.empty_cache()
    sites = {}
    for turn in range(world):
        if turn == rank:
            sites["matcher_sites"] = [matcher_site(torch, matcher, *match_cap.calls[0])]
            with torch.no_grad():
                sites["nms_sites"] = [nms_site(torch, nms, *nms_cap.calls[0], plain_iters=3)]
                sites["roi_sites"] = [roi_site(torch, poolers, [f.detach() for f in c[0]], *c[1:])
                                      for c in roi_cap.calls]
            sites["bwd_sites_roi"] = [
                roi_backward_site(torch, poolers, [f.detach() for f in c[0]], *c[1:],
                                  roi_cap.out_grads[i], "roi")
                for i, c in enumerate(roi_cap.calls)]
            torch.cuda.empty_cache()
        dist.barrier()
    return dict(equal, launches=launches, losses=losses, step_ms=times, traffic=traffic, images=b,
                gradient_mb=_tensor_bytes(grads) / 1e6, allreduce_ms=allreduce,
                param_mb=_tensor_bytes(list(model.parameters())) / 1e6,
                momentum_mb=_tensor_bytes(momentum) / 1e6,
                data_only_param_mb=full_param_bytes / 1e6, sharded=len(dims),
                peak_memory_gb=peak_gb, coords=[comm.data_rank(), comm.model_rank()],
                sites=sites)


def worker_tp_entry(torch, np, rank, world, work):
    """43. train_net on a (data 2, model 2) mesh: phase 22's flagship options
    (global batch 8) for 4 iterations (a checkpoint at 4), a
    resume to 6 that validates at 6 and runs the final test on the val tree;
    the model gathered (rank 0's copy kept for the parent); then test_net
    under the mesh on phase 18's known answer, phase 22's options."""
    from maskrcnn_tpu_torch.parallel import gather_state
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils import comm

    with open(os.path.join(work, "entry_job.json")) as f:
        job = json.load(f)
    mesh = ["TPU.MESH_AXES", "('data', 'model')", "TPU.MESH_SHAPE", "(-1, 2)"]
    out_dir = os.path.join(work, "tp_out")
    opts = job["opts"] + mesh + ["OUTPUT_DIR", out_dir]
    logs = LogLines()
    for name in ("maskrcnn_tpu_torch", "maskrcnn_tpu_torch.checkpointer"):
        logging.getLogger(name).addHandler(logs)
    gathered = []
    all_gather = comm.all_gather

    def recording(data):
        got = all_gather(data)
        if isinstance(data, dict) and all(isinstance(k, int) for k in data):
            gathered.append([sorted(d) for d in got])  # inference's shards by rank
        return got

    comm.all_gather = recording
    try:
        _override_images(job["images"])
        with environ(MASKRCNN_TPU_DATA_DIR=job["root"]):
            t0 = time.perf_counter()
            train_net.main(["--skip-test"] + opts + ["SOLVER.MAX_ITER", "4"])
            first_s = time.perf_counter() - t0
            first = list(logs.lines)
            logs.lines.clear()
            t0 = time.perf_counter()
            model, meters = train_net.main(opts + [
                "SOLVER.MAX_ITER", "6", "SOLVER.TEST_PERIOD", "6", "DATASETS.TEST",
                "('coco_2017_val',)", "TEST.IMS_PER_BATCH", "8"])
            second_s = time.perf_counter() - t0
            second = list(logs.lines)
        state, _ = gather_state(model)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in state.items()}, os.path.join(work, "tp_state.pth"))
        del model, state
        torch.cuda.empty_cache()
        train_gathered = list(gathered)
        gathered.clear()
        # phase 18's known answer, its batches of 8 on each data coordinate
        _override_images(job["eval_images"])
        with environ(MASKRCNN_TPU_DATA_DIR=job["eval_root"]):
            t0 = time.perf_counter()
            known = test_net.main(job["eval_opts"] + mesh + [
                "OUTPUT_DIR", os.path.join(work, "tp_known_out")])
            known_s = time.perf_counter() - t0
    finally:
        comm.all_gather = all_gather
    return {"saves": [os.path.basename(line.split()[-1]) for line in first
                      if line.startswith("Saving checkpoint to")],
            "resumed": "Loading checkpoint from " + os.path.join(out_dir, "model_final.pth")
            in second,
            "validated": any(line == "Validation at iteration 6" for line in second),
            "iterations": [[int(m) for line in lines for m in re.findall(r"iter: (\d+)", line)]
                           for lines in (first, second)],
            "losses": {k: m.global_avg for k, m in meters.meters.items() if k.startswith("loss")},
            "train_gathered": train_gathered, "known_gathered": gathered,
            "known": None if known is None else {k: dict(v) for k, v in known[0][0].results.items()},
            "coords": [comm.data_rank(), comm.model_rank()],
            "train_4_s": first_s, "resume_validate_test_s": second_s, "known_test_s": known_s}


WORKER_PHASES = {"f32": worker_f32, "bf16": worker_bf16, "entry": worker_entry,
                 "nccl": worker_nccl, "tp_f32": worker_tp_f32, "tp_bf16": worker_tp_bf16,
                 "tp_entry": worker_tp_entry}


def worker_main(argv):
    """python3 chip_smoke.py --worker PHASES RANK WORLD PORT DIR: one rank of
    the multi-card phases on cuda:0, its results in DIR/rank<RANK>.json.
    Every phase but "nccl" runs in a gloo group this process makes."""
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    phases, rank, world, port, work = argv[0].split(","), int(argv[1]), int(argv[2]), argv[3], \
        argv[4]
    try:
        torch.cuda.set_device(0)
        if phases != ["nccl"]:
            import datetime

            dist.init_process_group("gloo", init_method="tcp://localhost:" + port, rank=rank,
                                    world_size=world, timeout=datetime.timedelta(seconds=600))
        results = {"seconds": {}}
        for phase in phases:
            t0 = time.perf_counter()
            results[phase] = WORKER_PHASES[phase](torch, np, rank, world, work)
            results["seconds"][phase] = time.perf_counter() - t0
            print("rank {}: phase {} in {:.1f} s".format(rank, phase, time.perf_counter() - t0),
                  flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        return 1
    with open(os.path.join(work, "rank{}.json".format(rank)), "w") as f:
        json.dump(results, f)
    return 0


def main():
    if sys.argv[1:2] == ["--worker"]:
        return worker_main(sys.argv[2:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "maskrcnn_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        kind, count = run(torch)
    except SmokeError as e:
        print("chip_smoke FAILED: {}".format(e), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
