from . import (alexnet, machine_translation, mnist, se_resnext, stacked_lstm,
               transformer, vgg)
