from . import machine_translation, stacked_lstm, transformer
