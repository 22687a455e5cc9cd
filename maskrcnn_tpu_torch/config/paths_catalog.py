"""Dataset and model catalogs.

Port copy of maskrcnn_tpu/config/paths_catalog.py: the same dataset names
(the YAML configs' DATASETS.TRAIN / TEST) and the same layout under one data
root, so one data tree serves both packages. The root is "datasets" or the
MASKRCNN_TPU_DATA_DIR environment variable, read at each lookup.
ModelCatalog resolves the configs' ``catalog://`` weight names to the same
Detectron and ImageNet-pretrained URLs as the JAX package's;
utils/model_zoo.py finds them in the local cache.
"""

import os


class DatasetCatalog:
    DATA_DIR = "datasets"

    _COCO_SETS = {
        "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
        "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
        "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
        "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
        "coco_2014_minival": ("coco/val2014", "coco/annotations/instances_minival2014.json"),
        "coco_2014_valminusminival": (
            "coco/val2014",
            "coco/annotations/instances_valminusminival2014.json",
        ),
        "keypoints_coco_2014_train": (
            "coco/train2014",
            "coco/annotations/person_keypoints_train2014.json",
        ),
        "keypoints_coco_2014_val": (
            "coco/val2014",
            "coco/annotations/person_keypoints_val2014.json",
        ),
        "keypoints_coco_2014_minival": (
            "coco/val2014",
            "coco/annotations/person_keypoints_minival2014.json",
        ),
        "keypoints_coco_2014_valminusminival": (
            "coco/val2014",
            "coco/annotations/person_keypoints_valminusminival2014.json",
        ),
    }

    _VOC_SETS = {
        "voc_2007_train": ("voc/VOC2007", "train"),
        "voc_2007_val": ("voc/VOC2007", "val"),
        "voc_2007_test": ("voc/VOC2007", "test"),
        "voc_2012_train": ("voc/VOC2012", "train"),
        "voc_2012_val": ("voc/VOC2012", "val"),
        "voc_2012_test": ("voc/VOC2012", "test"),
    }

    # cocostyle VOC = COCODataset over pascal JSON annotations (reference
    # paths_catalog.py:54-65 — NOT PascalVOCDataset: the mask configs need
    # COCO-style segmentation records)
    _VOC_COCOSTYLE_SETS = {
        "voc_2007_train_cocostyle": (
            "voc/VOC2007/JPEGImages",
            "voc/VOC2007/Annotations/pascal_train2007.json",
        ),
        "voc_2007_val_cocostyle": (
            "voc/VOC2007/JPEGImages",
            "voc/VOC2007/Annotations/pascal_val2007.json",
        ),
        "voc_2007_test_cocostyle": (
            "voc/VOC2007/JPEGImages",
            "voc/VOC2007/Annotations/pascal_test2007.json",
        ),
        "voc_2012_train_cocostyle": (
            "voc/VOC2012/JPEGImages",
            "voc/VOC2012/Annotations/pascal_train2012.json",
        ),
        "voc_2012_val_cocostyle": (
            "voc/VOC2012/JPEGImages",
            "voc/VOC2012/Annotations/pascal_val2012.json",
        ),
    }

    _CITYSCAPES_SETS = {
        "cityscapes_fine_instanceonly_seg_train_cocostyle": (
            "cityscapes/images",
            "cityscapes/annotations/instancesonly_filtered_gtFine_train.json",
        ),
        "cityscapes_fine_instanceonly_seg_val_cocostyle": (
            "cityscapes/images",
            "cityscapes/annotations/instancesonly_filtered_gtFine_val.json",
        ),
        "cityscapes_fine_instanceonly_seg_test_cocostyle": (
            "cityscapes/images",
            "cityscapes/annotations/instancesonly_filtered_gtFine_test.json",
        ),
    }

    # native gtFine-layout cityscapes sets (reference paths_catalog.py:112-155)
    _CITYSCAPES_NATIVE_SETS = {
        "cityscapes_poly_instance_train": dict(split="train", mode="poly"),
        "cityscapes_poly_instance_val": dict(split="val", mode="poly"),
        "cityscapes_poly_instance_minival": dict(split="val", mode="poly", mini=10),
        "cityscapes_mask_instance_train": dict(split="train", mode="mask"),
        "cityscapes_mask_instance_val": dict(split="val", mode="mask"),
        "cityscapes_mask_instance_minival": dict(split="val", mode="mask", mini=10),
    }

    @staticmethod
    def get(name):
        root = os.environ.get("MASKRCNN_TPU_DATA_DIR", DatasetCatalog.DATA_DIR)
        if name in DatasetCatalog._CITYSCAPES_NATIVE_SETS:
            args = dict(DatasetCatalog._CITYSCAPES_NATIVE_SETS[name])
            args["img_dir"] = os.path.join(root, "cityscapes/leftImg8bit")
            args["ann_dir"] = os.path.join(root, "cityscapes/gtFine")
            return dict(factory="CityScapesDataset", args=args)
        if (
            name in DatasetCatalog._COCO_SETS
            or name in DatasetCatalog._CITYSCAPES_SETS
            or name in DatasetCatalog._VOC_COCOSTYLE_SETS
        ):
            table = dict(
                DatasetCatalog._COCO_SETS,
                **DatasetCatalog._CITYSCAPES_SETS,
                **DatasetCatalog._VOC_COCOSTYLE_SETS,
            )
            img_dir, ann_file = table[name]
            return dict(
                factory="COCODataset",
                args=dict(
                    root=os.path.join(root, img_dir),
                    ann_file=os.path.join(root, ann_file),
                    remove_images_without_annotations="train" in name,
                ),
            )
        if name in DatasetCatalog._VOC_SETS:
            data_dir, split = DatasetCatalog._VOC_SETS[name]
            return dict(
                factory="PascalVOCDataset",
                args=dict(data_dir=os.path.join(root, data_dir), split=split),
            )
        raise RuntimeError("Dataset not available in catalog: {}".format(name))


class ModelCatalog:
    """Resolves catalog:// URIs to Detectron/ImageNet pretrained weight URLs."""

    S3_PREFIX = "https://dl.fbaipublicfiles.com/detectron"

    _IMAGENET = {
        "MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
        "MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
        "MSRA/R-50-GN": "ImageNetPretrained/47261647/R-50-GN.pkl",
        "MSRA/R-101-GN": "ImageNetPretrained/47592356/R-101-GN.pkl",
        "FAIR/20171220/X-101-32x8d": "ImageNetPretrained/20171220/X-101-32x8d.pkl",
        "FAIR/20171220/X-101-64x4d": "ImageNetPretrained/20171220/X-101-64x4d.pkl",
    }

    _DETECTRON_12_2017 = {
        "35857197/e2e_faster_rcnn_R-50-C4_1x": "01_33_49.iAX0mXvW",
        "35857345/e2e_faster_rcnn_R-50-FPN_1x": "01_36_30.cUF7QR7I",
        "35857890/e2e_faster_rcnn_R-101-FPN_1x": "01_38_50.sNxI7sX7",
        "36761737/e2e_faster_rcnn_X-101-32x8d-FPN_1x": "06_31_39.5MIHi1fZ",
        "35858791/e2e_mask_rcnn_R-50-C4_1x": "01_45_57.ZgkA7hPB",
        "35858933/e2e_mask_rcnn_R-50-FPN_1x": "01_48_14.DzEQe4wC",
        "35861795/e2e_mask_rcnn_R-101-FPN_1x": "02_31_37.KqyEK4tT",
        "36761843/e2e_mask_rcnn_X-101-32x8d-FPN_1x": "06_35_59.RZotkLKI",
        "37129812/e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x": "09_35_36.8pzTQKYK",
        "37697547/e2e_keypoint_rcnn_R-50-FPN_1x": "08_42_54.kdzV35ao",
    }

    @staticmethod
    def get(name):
        if name.startswith("Caffe2Detectron/COCO"):
            return ModelCatalog.get_c2_detectron_12_2017_baselines(name)
        if name.startswith("ImageNetPretrained"):
            return ModelCatalog.get_c2_imagenet_pretrained(name)
        raise RuntimeError("model not present in the catalog {}".format(name))

    @staticmethod
    def get_c2_imagenet_pretrained(name):
        name = name[len("ImageNetPretrained/"):]
        return "/".join([ModelCatalog.S3_PREFIX, ModelCatalog._IMAGENET[name]])

    @staticmethod
    def get_c2_detectron_12_2017_baselines(name):
        name = name[len("Caffe2Detectron/COCO/"):]
        dataset = "keypoints_" if "keypoint" in name else ""
        signature = ModelCatalog._DETECTRON_12_2017[name]
        unique = name.split("/")[0]
        model_name = name.split("/")[1]
        return "/".join(
            [
                ModelCatalog.S3_PREFIX,
                "35998355/12_2017_baselines",
                "{}.yaml.{}".format(model_name, signature),
                "output/train/{}coco_2014_train%3A{}coco_2014_valminusminival".format(
                    dataset, dataset
                ),
                "generalized_rcnn",
                "model_final.pkl",
            ]
        )
