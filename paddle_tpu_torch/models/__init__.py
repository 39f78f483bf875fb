from . import alexnet, machine_translation, stacked_lstm, transformer, vgg
