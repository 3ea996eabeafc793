"""Training substrate: optimizer, data pipeline, train step, checkpoints."""
from repro_torch.training.checkpoint import (checkpoint_step,  # noqa: F401
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import (DataConfig,  # noqa: F401
                                       SyntheticDataset)
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: F401
                                            AdamWState, adamw_update,
                                            init_adamw, lr_at)
from repro_torch.training.train_loop import (TrainState,  # noqa: F401
                                             chunked_ce_loss,
                                             init_train_state,
                                             make_train_step)
