"""The plain reference of the benchmark's configurations (torch, float64),
independent of the program under test: it imports nothing of
``videorenderer_tpu_torch`` and takes nothing the program made.  One
module a chain, named by a configuration's ``reference``:
``frame(config, planes, scene, ar)`` gives one frame's output codes;
``oracle`` holds the steps the chains share."""
