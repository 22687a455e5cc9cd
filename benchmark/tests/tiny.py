"""Tiny overrides of the benchmark's cells for CPU tests: narrow widths,
small images and few ROIs, float32 or bfloat16 compute."""

NARROW = {
    "MODEL": {
        "ROI_BOX_HEAD": {"NUM_CLASSES": 5, "MLP_HEAD_DIM": 32},
        "RESNETS": {"RES2_OUT_CHANNELS": 32, "STEM_OUT_CHANNELS": 8, "WIDTH_PER_GROUP": 8},
        "ROI_MASK_HEAD": {"CONV_LAYERS": [16, 16, 16, 16]},
        "RPN": {"PRE_NMS_TOP_N_TRAIN": 96, "POST_NMS_TOP_N_TRAIN": 48,
                "FPN_POST_NMS_TOP_N_TRAIN": 64, "PRE_NMS_TOP_N_TEST": 96,
                "POST_NMS_TOP_N_TEST": 40, "FPN_POST_NMS_TOP_N_TEST": 40},
        "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 32, "DETECTIONS_PER_IMG": 10},
    },
    "TPU": {"MAX_GT_BOXES": 6, "GT_MASK_SIZE": 16, "MASK_ROI_CAP": 4},
    "INPUT": {"MIN_SIZE_TEST": 64, "MAX_SIZE_TEST": 100},
}


def overrides(workload, dtype="float32"):
    """Overrides of `workload`'s configuration and traffic for a CPU run."""
    cfg = {k: dict(v) for k, v in NARROW.items()}
    cfg["TPU"] = dict(cfg["TPU"], COMPUTE_DTYPE=dtype)
    if "C4" in workload:
        cfg["MODEL"] = dict(cfg["MODEL"], RESNETS=dict(cfg["MODEL"]["RESNETS"],
                                                       BACKBONE_OUT_CHANNELS=128))
    else:
        cfg["MODEL"] = dict(cfg["MODEL"], RESNETS=dict(cfg["MODEL"]["RESNETS"],
                                                       BACKBONE_OUT_CHANNELS=16))
    traffic = {"batch": 2, "pool": 3, "trace_steps": 1, "trace_batches": 2}
    if "train" in workload:
        traffic.update(image_size=[64, 96], gt={"side_max": 40})
    else:
        traffic.update(source_sizes=[[48, 64], [64, 48]], pool=4, checked_batches=2)
    # at 16 channels the published 0.001 of the mask deconv leaves every mask
    # logit within 1e-3 of 0: no rounding could move a probability by 0.02
    init = [["^roi_heads[.]mask[.]predictor[.]conv5_mask[.]weight$", "normal", 0.05]]
    return {"config": cfg, "traffic": traffic, "init": init}
