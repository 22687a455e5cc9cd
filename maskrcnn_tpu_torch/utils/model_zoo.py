"""The local cache of pretrained weight files.

Port of maskrcnn_tpu/utils/model_zoo.py (after the reference
maskrcnn_benchmark/utils/model_zoo.py): a URL names a file in the cache
directory, MASKRCNN_TPU_CACHE or ~/.cache/maskrcnn_tpu, the JAX package's,
so one pre-populated cache serves both packages. Where the file is missing,
rank 0 downloads it and the other ranks wait at a barrier; without a
network the error names where to place it.

The cached file is the URL's basename, with the URL's query appended as in
the JAX package, except for Detectron's ``.../model_final.pkl``: every
12_2017 baseline ends so, with no query, so such a URL is named by its
whole path with "/" replaced by "_", as maskrcnn-benchmark names it (the
JAX package gives all of them one file, ROADMAP.md Queue 3).
"""

import os
import sys
from urllib.parse import urlparse

from . import comm


def cached_name(url):
    """The file name under which `url` is cached."""
    parts = urlparse(url)
    filename = os.path.basename(parts.path)
    if filename == "model_final.pkl":
        return parts.path.replace("/", "_")
    if parts.query:
        filename = filename + "_" + parts.query.replace("/", "_")
    return filename


def cache_url(url, model_dir=None):
    """The local path of `url`'s file, downloaded by rank 0 if it is not in
    the cache yet; RuntimeError naming the path if it cannot be had."""
    if model_dir is None:
        model_dir = os.environ.get(
            "MASKRCNN_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "maskrcnn_tpu"))
    cached_file = os.path.join(model_dir, cached_name(url))
    if not os.path.exists(cached_file) and comm.is_main_process():
        import urllib.request

        os.makedirs(model_dir, exist_ok=True)
        sys.stderr.write("Downloading: {} to {}\n".format(url, cached_file))
        partial = cached_file + ".part"
        try:
            urllib.request.urlretrieve(url, partial)
            os.replace(partial, cached_file)
        except OSError as e:
            sys.stderr.write("download failed: {}\n".format(e))
    comm.synchronize()
    if not os.path.exists(cached_file):
        raise RuntimeError("weight file {} not available (no network?): place it at {}"
                           .format(url, cached_file))
    return cached_file
