"""On-device training augmentation: RandAugment, random erasing, MixUp/CutMix.

Each is split into "sample" (the random parameters, drawn from a
``torch.Generator`` the train step owns) and "apply" (deterministic given
those parameters), so that a test can hand the port the parameters the JAX
package drew and compare the outputs.
"""
