"""Models: parameter trees and NN primitives (`nn`), priors, the encoder and the decoder.

Import the submodules directly; the package imports none of them, since the
fields depend on `nn` and the decoder on the fields.
"""
