"""Host IO of the port: the counterpart of ``ark_tpu/io``, kept in the port.

``io_utils`` (listing, path checks), ``feather_utils`` (pyarrow feathers),
``image_utils`` (TIFF via imageio, imported inside the two functions, so the
card's machine, which lacks imageio, imports every module), ``load_utils``
(cohort loaders returning the port's ``DataArray``) and ``misc_utils``
(``save_figure``; the argument checks live in ``ark_tpu_torch.utils.misc_utils``).
Nothing is imported here, so importing one module loads only that module.
"""
