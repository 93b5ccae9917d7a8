"""Caffe importer (the JAX package's ``caffe/``)."""

from analytics_zoo_tpu_torch.caffe.loader import (  # noqa: F401
    UnsupportedCaffeLayer, decode_caffemodel, load_caffe, load_caffe_parts,
    parse_prototxt)
