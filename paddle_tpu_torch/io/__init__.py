"""``paddle_tpu/io`` counterpart: datasets and samplers (copies of the
JAX modules) and the `DataLoader` over torch tensors."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)
from .dataloader import (  # noqa: F401
    DataLoader, default_collate_fn, get_worker_info,
)
