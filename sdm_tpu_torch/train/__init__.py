from sdm_tpu_torch.train.step import (TrainState, create_train_state,
                                      make_optimizer, make_train_step)
