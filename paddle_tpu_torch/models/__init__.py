from . import (alexnet, ctr_deepfm, fluid_encoder, machine_translation,
               mnist, se_resnext, stacked_lstm, transformer, vgg)
