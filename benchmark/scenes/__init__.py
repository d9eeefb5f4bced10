"""The benchmark's scene generators, one module per scene, each a frozen
copy of a generator of ``vello_tpu_torch/scenes/test_scenes.py``. Each
module's ``build(api, config, seed, args)`` draws one scene through the
Scene API of ``api`` (the port's, or the plain reference's copy of it),
so both sides get the same description from the same seed."""
