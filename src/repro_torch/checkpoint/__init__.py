from .bigstore import BigStore, BigStoreHost
from .manager import flatten_state, state_shard_names, unflatten_state
