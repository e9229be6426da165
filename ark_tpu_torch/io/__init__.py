"""Host IO of the port: the counterpart of ``ark_tpu/io``, kept in the port.

``io_utils`` (listing, path checks), ``feather_utils`` (pyarrow feathers),
``tiff`` (the port's TIFF codec: numpy, zlib and the standard library),
``image_utils`` (``save_image``/``read_image`` over it), ``ome_utils``
(OME-TIFF bundles), ``load_utils``
(cohort loaders returning the port's ``DataArray``) and ``misc_utils``
(``save_figure``; the argument checks live in ``ark_tpu_torch.utils.misc_utils``).
Nothing is imported here, so importing one module loads only that module.
"""
