"""Samplers: distributed shard, random and sequential order, aspect-ratio
grouping, iteration-based.

Port copy of maskrcnn_tpu/data/samplers.py (after the reference
maskrcnn_benchmark/data/samplers): numpy ``RandomState`` seeded as there
(seed + epoch), so the index sequence is the JAX package's.
  * DistributedSampler: epoch-seeded permutation, padded to a multiple of
    num_replicas, contiguous rank slice (offset = num_samples * rank)
  * GroupedBatchSampler: batches contain only same-group elements, order
    follows the underlying sampler as closely as possible
  * IterationBasedBatchSampler: resample indefinitely until num_iterations
"""

import math

import numpy as np


class DistributedSampler:
    def __init__(self, dataset, num_replicas=1, rank=0, shuffle=True, seed=0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            indices = g.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to make evenly divisible
        indices += indices[: self.total_size - len(indices)]
        offset = self.num_samples * self.rank
        return iter(indices[offset:offset + self.num_samples])

    def __len__(self):
        return self.num_samples


class SequentialSampler:
    def __init__(self, dataset):
        self.n = len(dataset)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    def __init__(self, dataset, seed=0):
        self.n = len(dataset)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        g = np.random.RandomState(self.seed + self.epoch)
        return iter(g.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class BatchSampler:
    def __init__(self, sampler, batch_size, drop_last=False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class GroupedBatchSampler:
    """Batches only within the same group id, preserving sampler order."""

    def __init__(self, sampler, group_ids, batch_size, drop_uneven=False):
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.drop_uneven = drop_uneven

    def __iter__(self):
        buffers = {}
        order = []
        for idx in self.sampler:
            g = int(self.group_ids[idx])
            buffers.setdefault(g, []).append(idx)
            if len(buffers[g]) == self.batch_size:
                order.append(buffers.pop(g))
        if not self.drop_uneven:
            for g in sorted(buffers):
                if buffers[g]:
                    order.append(buffers[g])
        return iter(order)

    def __len__(self):
        # recomputing each call is acceptable (reference caches similarly)
        return sum(1 for _ in iter(self))


class IterationBasedBatchSampler:
    def __init__(self, batch_sampler, num_iterations, start_iter=0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        while iteration <= self.num_iterations:
            if hasattr(self.batch_sampler.sampler, "set_epoch"):
                self.batch_sampler.sampler.set_epoch(iteration)
            for batch in self.batch_sampler:
                iteration += 1
                if iteration > self.num_iterations:
                    break
                yield batch

    def __len__(self):
        return self.num_iterations
