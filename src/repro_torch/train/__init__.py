from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .data import DataConfig, SyntheticLM
from .delta_sync import DeltaAggregator, GradDelta
