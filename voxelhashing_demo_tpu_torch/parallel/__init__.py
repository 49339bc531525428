"""The multi-device layer: one rank per mesh position over
``torch.distributed`` (``distributed``), the sharded SLAM stack
(``sharded``) and the rank launcher (``launch``)."""
