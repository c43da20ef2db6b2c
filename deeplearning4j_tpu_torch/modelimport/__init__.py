"""Keras-1 model import (``KerasModelImport``) and the HDF5 subset its
archives use (``hdf5.H5File``), read and written without an HDF5 library."""
