from . import transformer
