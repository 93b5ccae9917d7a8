"""Utility surface: ``nest`` structure flatten / pack (the tf.nest
contract over lists, tuples and dicts) and file helpers.  The JAX
package's ``utils``, copied: neither module touches JAX."""

from analytics_zoo_tpu_torch.utils.common import get_file_list, to_list
from analytics_zoo_tpu_torch.utils.nest import (flatten, map_structure,
                                                pack_sequence_as)

__all__ = ["flatten", "pack_sequence_as", "map_structure",
           "get_file_list", "to_list"]
