from . import (alexnet, ctr_deepfm, machine_translation, mnist, se_resnext,
               stacked_lstm, transformer, vgg)
