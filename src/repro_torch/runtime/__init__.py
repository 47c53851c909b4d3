from .elastic import Assignment, ElasticController, derive_assignment
from .ft import FTConfig, FTTrainer
