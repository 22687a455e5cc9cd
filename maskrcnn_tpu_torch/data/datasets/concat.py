"""ConcatDataset / ListDataset / AbstractDataset.

Port copy of maskrcnn_tpu/data/datasets/concat.py (after the reference
maskrcnn_benchmark/data/datasets/{concat_dataset.py, list_dataset.py,
abstract.py}): concatenation with get_img_info passed through and the
global index reported, a dataset over a list of image paths, and the
documented custom-dataset interface. Images are HWC uint8 RGB numpy arrays,
as the port's transforms take them; ListDataset decodes them with Pillow in
``_load_image`` only.
"""

import bisect

import numpy as np


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return dataset_idx, sample_idx

    def __getitem__(self, idx):
        d, s = self._locate(idx)
        img, target, _ = self.datasets[d][s]
        return img, target, idx

    def get_idxs(self, idx):
        return self._locate(idx)

    def get_img_info(self, idx):
        d, s = self._locate(idx)
        return self.datasets[d].get_img_info(s)

    @property
    def contiguous_category_id_to_json_id(self):
        return self.datasets[0].contiguous_category_id_to_json_id


class ListDataset:
    """Dataset over an explicit list of {"img_path", "target"} dicts."""

    def __init__(self, image_lists, transforms=None):
        self.image_lists = image_lists
        self.transforms = transforms

    def __len__(self):
        return len(self.image_lists)

    def _load_image(self, item):
        from PIL import Image

        with Image.open(self.image_lists[item]["img_path"]) as im:
            return np.array(im.convert("RGB"))

    def __getitem__(self, item):
        img = self._load_image(item)
        target = self.image_lists[item].get("target")
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target, item

    def get_img_info(self, item):
        entry = self.image_lists[item]
        if "width" in entry:
            return entry
        from PIL import Image

        with Image.open(entry["img_path"]) as im:
            w, h = im.size
        return {"width": w, "height": h}


class AbstractDataset:
    """The custom-dataset contract (reference abstract.py): subclasses
    provide __getitem__ -> (image, BoxList, idx), __len__, get_img_info,
    and optionally CLASSES / name mappings for evaluation."""

    CLASSES = ()

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def get_img_info(self, index):
        raise NotImplementedError

    def map_class_id_to_class_name(self, class_id):
        return self.CLASSES[class_id]
