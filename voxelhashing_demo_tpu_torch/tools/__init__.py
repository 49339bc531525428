"""The port's counterparts of the TPU probe scripts under ``tools/``.

One module per probe, each with ``main(device=None)`` (the card unless the
caller names the CPU) and runnable as
``python -m voxelhashing_demo_tpu_torch.tools.<name>``:

- ``exp_vmem_gather`` (``tools/exp_pallas_vmem_gather.py``): 65 536 flat
  gathers from a 640x480 image, three index forms (K16 ``take_flat``);
- ``exp_gather`` (``tools/exp_pallas_gather.py``): 524 288 flat gathers
  (K16);
- ``exp_gather2`` (``tools/exp_pallas_gather2.py``): ``take_along_axis``
  on both axes (K17) and the two-step window gather over 128 blocks (K18);
- ``exp_integrate`` (``tools/exp_pallas_integrate.py``): one integrate
  chunk, the gather alone (K16) and gather plus fuse (K19);
- ``exp_landed`` (``tools/exp_pallas_landed.py``): the window gathers K1
  and K2 at 128 x 512 and the frame step with and without K1.

Each prints its variants' lines (device time warm and cold L2, wrapper
time, agreement with the plain version) and ``device:`` with the card's
name and power limit, and returns them as a dict.  Nothing runs when a
module is imported.
"""
