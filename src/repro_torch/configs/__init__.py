from . import dawn
