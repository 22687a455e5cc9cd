"""The port's own spans (utils/profiling.py:PORT_SPANS) that a Mask R-CNN
pass reaches, by pass and device; imports neither JAX nor torch, so the
card's tests (run without conftest) share it with the CPU tests.
roi_pool.bwd is the ROIAlign kernels' backward, which runs on the card only;
a training step opens no box_postproc.nms. A group-norm model's passes
(configs/gn_baselines/) reach GN's too, by device: group_norm around each
group norm, inside the stage that calls it (GN_HOLDERS), and on the card
group_norm.bwd around the kernels' backward, inside backward."""

TRAIN = {"anchors", "anchors.wait", "proposals.candidates", "proposals.nms", "proposals.select",
         "rpn_loss.match", "roi_pool", "backward", "grad_reduce"}
INFER = {"anchors", "anchors.wait", "proposals.candidates", "proposals.nms", "proposals.select",
         "box_postproc.nms", "roi_pool"}
PORT_SPANS_REACHED = {("train", "cpu"): TRAIN, ("train", "cuda"): TRAIN | {"roi_pool.bwd"},
                      ("infer", "cpu"): INFER, ("infer", "cuda"): INFER}
GN = {"cpu": {"group_norm"}, "cuda": {"group_norm", "group_norm.bwd"}}
GN_HOLDERS = {"stem", "layer1", "layer2", "layer3", "layer4", "fpn", "box_head", "mask_head"}
