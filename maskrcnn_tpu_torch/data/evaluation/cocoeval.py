"""COCO-style evaluation (pycocotools-compatible, pure numpy).

Port copy of maskrcnn_tpu/data/evaluation/cocoeval.py, which re-implements
the COCOeval protocol from its published specification (pycocotools is not
a dependency of either package): greedy per-category matching at IoU
thresholds 0.50:0.05:0.95, crowd-aware matching, area ranges, maxDets,
101-point interpolated AP, and the standard 12-metric summary. Matches
pycocotools semantics:

  * detections sorted by score (stable), gts sorted ignore-last
  * a detection may match an ignored gt (and is then ignored itself)
  * crowd gts can absorb any number of detections (iscrowd IoU = inter/dt)
  * unmatched detections outside the area range are ignored

IoU backends: bbox (xywh, no +1 convention: COCO's own), segm (RLE, through
the native run intersection of utils/maskops.py), and keypoint OKS with the
standard 17 sigmas.
"""

import numpy as np

from ...utils import maskops

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)

KPT_SIGMAS = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
     1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0

AREA_RNGS = {
    "all": [0, 1e10],
    "small": [0, 32 ** 2],
    "medium": [32 ** 2, 96 ** 2],
    "large": [96 ** 2, 1e10],
}


def bbox_iou_xywh(dt, gt, iscrowd):
    """COCO bbox IoU: boxes are xywh, areas w*h (no +1)."""
    d, g = len(dt), len(gt)
    out = np.zeros((d, g))
    for j in range(g):
        gx, gy, gw, gh = gt[j]
        ga = gw * gh
        for i in range(d):
            dx, dy, dw, dh = dt[i]
            da = dw * dh
            ix = min(dx + dw, gx + gw) - max(dx, gx)
            iy = min(dy + dh, gy + gh) - max(dy, gy)
            if ix <= 0 or iy <= 0:
                continue
            inter = ix * iy
            denom = da if iscrowd[j] else da + ga - inter
            if denom > 0:
                out[i, j] = inter / denom
    return out


def oks_iou(dt_kps, gt_anns):
    """OKS between detected keypoints [D, K*3] and gt annotations."""
    d = len(dt_kps)
    g = len(gt_anns)
    out = np.zeros((d, g))
    vars_ = (KPT_SIGMAS * 2) ** 2
    for j, gt in enumerate(gt_anns):
        gkp = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
        xg, yg, vg = gkp[:, 0], gkp[:, 1], gkp[:, 2]
        k1 = int((vg > 0).sum())
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        area = gt.get("area", bb[2] * bb[3])
        for i, dkp in enumerate(dt_kps):
            dk = np.asarray(dkp, np.float64).reshape(-1, 3)
            xd, yd = dk[:, 0], dk[:, 1]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros_like(xg)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / vars_ / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] > 0 else 0.0
    return out


class COCOEvaluator:
    """Evaluate detections against a COCODataset's annotations.

    dataset: an object exposing .ids, .imgs, .anns_by_img, .categories
    (maskrcnn_tpu COCODataset). predictions: dict image_id -> list of
    detection dicts {"category_id", "score", "bbox" (xywh) | "segmentation"
    (RLE) | "keypoints"}.
    """

    def __init__(self, dataset, iou_type="bbox"):
        assert iou_type in ("bbox", "segm", "keypoints")
        self.dataset = dataset
        self.iou_type = iou_type
        self.max_dets = [1, 10, 100] if iou_type != "keypoints" else [20]
        self.cat_ids = sorted(dataset.categories.keys())
        if iou_type == "keypoints":
            self.cat_ids = [c for c in self.cat_ids
                            if dataset.categories[c] == "person"] or self.cat_ids[:1]

    def _gt_for(self, img_id, cat_id):
        anns = [
            a for a in self.dataset.anns_by_img.get(img_id, [])
            if a["category_id"] == cat_id
        ]
        if self.iou_type == "keypoints":
            anns = [a for a in anns if "keypoints" in a]
        return anns

    def _gt_rle(self, ann, h, w):
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            if isinstance(seg.get("counts"), list):
                return {"size": seg["size"], "counts":
                        maskops.rle_counts_to_string(seg["counts"])}
            return seg
        return maskops.polygons_to_rle(seg, h, w)

    def _compute_iou(self, dts, gts, img_info):
        if len(dts) == 0 or len(gts) == 0:
            return np.zeros((len(dts), len(gts)))
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "bbox":
            d = np.asarray([dt["bbox"] for dt in dts], np.float64)
            g = np.asarray([gt["bbox"] for gt in gts], np.float64)
            return bbox_iou_xywh(d, g, iscrowd)
        if self.iou_type == "segm":
            h, w = img_info["height"], img_info["width"]
            d_rles = [dt["segmentation"] for dt in dts]
            g_rles = [self._gt_rle(gt, h, w) for gt in gts]
            return maskops.rle_iou(d_rles, g_rles, iscrowd=iscrowd)
        return oks_iou([dt["keypoints"] for dt in dts], gts)

    def _gt_area(self, g):
        if "area" in g:
            return g["area"]
        bb = g["bbox"]
        return bb[2] * bb[3]

    def evaluate(self, predictions):
        """predictions: {image_id: [det dicts]}. Returns the stats dict."""
        img_ids = list(self.dataset.ids)
        area_names = ["all", "small", "medium", "large"]
        if self.iou_type == "keypoints":
            area_names = ["all", "medium", "large"]
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(area_names)
        M = len(self.max_dets)

        # per (cat, img): iou matrix + sorted dts/gts, reused across areas
        eval_imgs = {}
        for k, cat in enumerate(self.cat_ids):
            for img_id in img_ids:
                gts = self._gt_for(img_id, cat)
                dts = [d for d in predictions.get(img_id, [])
                       if d["category_id"] == cat]
                if len(gts) == 0 and len(dts) == 0:
                    continue
                dts = sorted(dts, key=lambda d: -d["score"])[: max(self.max_dets)]
                info = self.dataset.imgs[img_id]
                ious = self._compute_iou(dts, gts, info)
                eval_imgs[(k, img_id)] = (dts, gts, ious)

        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores_out = -np.ones((T, R, K, A, M))

        for k in range(K):
            for a, aname in enumerate(area_names):
                rng = AREA_RNGS[aname]
                for m, max_det in enumerate(self.max_dets):
                    dt_scores_all = []
                    dtm_all = []
                    dtig_all = []
                    n_gt = 0
                    for img_id in img_ids:
                        item = eval_imgs.get((k, img_id))
                        if item is None:
                            continue
                        dts, gts, ious = item
                        dts = dts[:max_det]
                        gt_ignore = np.array([
                            bool(g.get("iscrowd", 0))
                            or g.get("ignore", False)
                            or not (rng[0] <= self._gt_area(g) < rng[1])
                            or (self.iou_type == "keypoints"
                                and sum(g["keypoints"][2::3]) == 0)
                            for g in gts
                        ], bool) if gts else np.zeros(0, bool)
                        # sort gts: non-ignored first (stable)
                        order = np.argsort(gt_ignore, kind="stable")
                        gts_s = [gts[i] for i in order]
                        gtig = gt_ignore[order]
                        iou_s = ious[:len(dts)][:, order] if len(gts) else \
                            np.zeros((len(dts), 0))

                        D, G = len(dts), len(gts_s)
                        dtm = np.zeros((T, D))
                        gtm = np.zeros((T, G))
                        dtig = np.zeros((T, D), bool)
                        for t, thr in enumerate(IOU_THRS):
                            for di in range(D):
                                best = min(thr, 1 - 1e-10)
                                match = -1
                                for gi in range(G):
                                    if gtm[t, gi] > 0 and not gts_s[gi].get("iscrowd", 0):
                                        continue
                                    if match > -1 and not gtig[match] and gtig[gi]:
                                        break  # past non-ignored into ignored: stop
                                    if iou_s[di, gi] < best:
                                        continue
                                    best = iou_s[di, gi]
                                    match = gi
                                if match == -1:
                                    continue
                                dtig[t, di] = gtig[match]
                                dtm[t, di] = 1
                                gtm[t, match] = 1
                        # unmatched dts outside area range ignored
                        dt_out = np.array([
                            not (rng[0] <= self._dt_area(d) < rng[1]) for d in dts
                        ], bool) if D else np.zeros(0, bool)
                        dtig = dtig | (dtm == 0) & dt_out[None, :]

                        dt_scores_all.extend(d["score"] for d in dts)
                        dtm_all.append(dtm)
                        dtig_all.append(dtig)
                        n_gt += int((~gtig).sum())

                    if n_gt == 0:
                        continue
                    if dt_scores_all:
                        scores = np.asarray(dt_scores_all)
                        dtm_cat = np.concatenate(dtm_all, axis=1)
                        dtig_cat = np.concatenate(dtig_all, axis=1)
                        order = np.argsort(-scores, kind="mergesort")
                        scores = scores[order]
                        dtm_cat = dtm_cat[:, order]
                        dtig_cat = dtig_cat[:, order]
                    else:
                        scores = np.zeros(0)
                        dtm_cat = np.zeros((T, 0))
                        dtig_cat = np.zeros((T, 0), bool)

                    tps = (dtm_cat == 1) & ~dtig_cat
                    fps = (dtm_cat == 0) & ~dtig_cat
                    tp_sum = np.cumsum(tps, axis=1)
                    fp_sum = np.cumsum(fps, axis=1)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        # make precision monotone decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = scores[pi]
                        precision[t, :, k, a, m] = q
                        scores_out[t, :, k, a, m] = ss

        self.precision = precision
        self.recall = recall
        self.area_names = area_names
        return self._summarize()

    def _dt_area(self, d):
        if self.iou_type == "segm":
            return maskops.rle_area(d["segmentation"])
        bb = d.get("bbox")
        if bb is not None:
            return bb[2] * bb[3]
        return 0.0

    def _summ(self, ap=1, iou_thr=None, area="all", max_det=100):
        a = self.area_names.index(area)
        m = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                t = int(np.argmin(np.abs(IOU_THRS - iou_thr)))
                s = s[t:t + 1]
            s = s[:, :, :, a, m]
        else:
            s = self.recall
            if iou_thr is not None:
                t = int(np.argmin(np.abs(IOU_THRS - iou_thr)))
                s = s[t:t + 1]
            s = s[:, :, a, m]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def _summarize(self):
        md = max(self.max_dets)
        if self.iou_type == "keypoints":
            return {
                "AP": self._summ(1, None, "all", md),
                "AP50": self._summ(1, 0.5, "all", md),
                "AP75": self._summ(1, 0.75, "all", md),
                "APm": self._summ(1, None, "medium", md),
                "APl": self._summ(1, None, "large", md),
                "AR": self._summ(0, None, "all", md),
                "AR50": self._summ(0, 0.5, "all", md),
                "AR75": self._summ(0, 0.75, "all", md),
                "ARm": self._summ(0, None, "medium", md),
                "ARl": self._summ(0, None, "large", md),
            }
        return {
            "AP": self._summ(1, None, "all", md),
            "AP50": self._summ(1, 0.5, "all", md),
            "AP75": self._summ(1, 0.75, "all", md),
            "APs": self._summ(1, None, "small", md),
            "APm": self._summ(1, None, "medium", md),
            "APl": self._summ(1, None, "large", md),
            "AR@1": self._summ(0, None, "all", self.max_dets[0]),
            "AR@10": self._summ(0, None, "all", self.max_dets[1]),
            "AR@100": self._summ(0, None, "all", md),
            "ARs": self._summ(0, None, "small", md),
            "ARm": self._summ(0, None, "medium", md),
            "ARl": self._summ(0, None, "large", md),
        }
