"""Unified Trainer API.

  TrainState            -- params + opt + step + rng + strategy state
  DistributedStrategy   -- Local / GTC / GTCShardMap / BMUFVmap (the
                           W workers or lanes on one device) /
                           BMUFShardMap (and GTCShardMap on a mesh:
                           each rank's lanes, runtime.cluster)
  DataSource            -- iterables of TrainBatch (epoch_source,
                           distill_shard_source, scheduled_source, chain);
                           compose with PrefetchingSource for the async
                           host -> device feed
  Trainer               -- fit() with one update per loss kind, lr a
                           runtime value (floats or Schedule objects),
                           BMUF block grouping, periodic checkpoints and
                           mid-stage resume, metrics sinks
"""
from repro_torch.optim.schedules import Schedule
from repro_torch.pipeline.prefetch import PrefetchingSource
from repro_torch.train.data import (DataSource, TrainBatch, chain,
                                    distill_shard_source, epoch_source,
                                    scheduled_source)
from repro_torch.train.metrics import JsonlSink, ListSink, MetricsSink, TeeSink
from repro_torch.train.state import TrainState
from repro_torch.train.strategies import (GTC, BMUFShardMap, BMUFVmap,
                                          DistributedStrategy, GTCShardMap,
                                          Local, init_opt, make_sgd_step)
from repro_torch.train.trainer import Trainer

__all__ = [
    "TrainState", "Trainer", "TrainBatch", "DataSource",
    "DistributedStrategy", "Local", "BMUFVmap", "BMUFShardMap", "GTC",
    "GTCShardMap", "make_sgd_step", "init_opt",
    "epoch_source", "distill_shard_source", "scheduled_source", "chain",
    "Schedule", "PrefetchingSource", "MetricsSink", "ListSink", "JsonlSink",
    "TeeSink",
]
