"""The parts of the JAX package's ``tfpark/converter.py`` that the
importers need: ``UnsupportedLayerError``, ``_stateless`` and
``GraphProgram`` (a converted model as ordered ops over a name-keyed
environment).

``convert_keras_model`` (tf.keras -> program) needs TensorFlow, which the
card machine lacks; it waits with the rest of tfpark (ROADMAP A10).
"""

from __future__ import annotations

__all__ = ["UnsupportedLayerError", "GraphProgram"]


class UnsupportedLayerError(ValueError):
    pass


# op signature: op(p, xs: List[tensor], training, rng, state_in)
#                 -> (out, state)

def _stateless(fn):
    def op(p, xs, training, rng, st):
        return fn(p, xs, training, rng), st
    return op


class GraphProgram:
    """A converted model: ordered ops over a name-keyed env.

    ``call(params, state, *inputs, training=, rng=)`` mirrors the layer
    protocol, so ``FunctionModel`` drops it into the Estimator.  ``params``
    is ``{node_name: {leaf: array}}``; ``rng`` is the dropout
    ``torch.Generator`` (every node draws from it in turn).
    """

    def __init__(self, nodes, input_names, output_names, params, state):
        self.nodes = nodes              # [(name, op, parent_names)]
        self.input_names = input_names
        self.output_names = output_names
        self.params = params            # {layer_name: pytree}
        self.state = state              # {layer_name: pytree}
        # whether a node draws from ``rng`` (FunctionModel then holds the
        # Estimator's dropout generator for it)
        self.has_dropout = True

    def call(self, params, state, *inputs, training=False, rng=None):
        if len(inputs) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs, "
                             f"got {len(inputs)}")
        env = dict(zip(self.input_names, inputs))
        new_state = dict(state)
        for name, op, parents in self.nodes:
            xs = [env[p] for p in parents]
            env[name], ns = op(params.get(name, {}), xs, training, rng,
                               state.get(name, {}))
            if ns:  # only stateful nodes carry state, keeping the tree
                new_state[name] = ns    # step-stable
        outs = [env[n] for n in self.output_names]
        return (outs[0] if len(outs) == 1 else outs), new_state
