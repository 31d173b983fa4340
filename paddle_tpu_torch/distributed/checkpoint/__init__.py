from .api import (  # noqa: F401
    CheckpointManager, load_state_dict, save_state_dict, verify_checkpoint,
    wait_async_save,
)
from .metadata import (  # noqa: F401
    CheckpointCorruptionError, LocalTensorIndex, LocalTensorMetadata,
    Metadata, shard_checksum,
)
