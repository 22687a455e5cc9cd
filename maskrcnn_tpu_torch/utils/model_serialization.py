"""Fuzzy state-dict alignment (suffix matching).

Port copy of maskrcnn_tpu/utils/model_serialization.py (after the reference
maskrcnn_benchmark/utils/model_serialization.py:10-81): a model key matches
a loaded key when the loaded key is a '.'-separated suffix of it; the
longest match wins. This lets an ImageNet backbone
("layer1.0.conv1.weight") load into the nested detector tree
("backbone.body.layer1.0.conv1.weight").
"""

import logging


def align_and_update_state_dicts(model_keys, loaded_keys):
    """Returns dict model_key -> loaded_key for the best suffix matches."""
    result = {}
    for mk in sorted(model_keys):
        best = ""
        for lk in loaded_keys:
            if mk == lk or mk.endswith("." + lk):
                if len(lk) > len(best):
                    best = lk
        if best:
            result[mk] = best
    logging.getLogger(__name__).debug(
        "suffix-matched %d/%d model keys", len(result), len(list(model_keys)))
    return result


def strip_prefix_if_present(state_dict, prefix="module."):
    keys = sorted(state_dict.keys())
    if not all(key.startswith(prefix) for key in keys):
        return state_dict
    return {key[len(prefix):]: value for key, value in state_dict.items()}
