! Fortran 90 bindings for the g4s_tpu_torch C embedding API
! (libg4s_torch_capi.so; the same entry points as the JAX package's
! libg4s_capi.so, so a program using this module links either library).
!
! The role of Cantera's Fortran surface: it ships an F90 interface over its
! clib (src/fortran/*, e.g. fct.cpp + cantera_funcs.f90) so legacy solvers
! can call the toolkit without C shims. The five entry points of
! runtime/native/capi.c are declared via ISO_C_BINDING, plus
! string-trimming wrappers so callers pass ordinary Fortran CHARACTER
! variables.
!
! Build (requires gfortran; tests/test_torch_runtime.py::test_fortran_binding
! skips without it):
!   gcc -shared -fPIC capi.c -o libg4s_torch_capi.so \
!       $(python3-config --includes --ldflags --embed)
!   gfortran my_prog.f90 g4s_capi.f90 -L. -lg4s_torch_capi
!
! All functions return 0 on success (handles >= 0), negative on error —
! the C contract documented at the top of capi.c.

module g4s_capi
  use iso_c_binding, only: c_char, c_int, c_double, c_null_char
  implicit none
  private
  public :: g4s_init, g4s_deeppot_load, g4s_deeppot_eval, &
            g4s_ignition_delay, g4s_finalize

  interface
    integer(c_int) function c_g4s_init(repo_path) &
        bind(c, name="g4s_init")
      import :: c_char, c_int
      character(kind=c_char), intent(in) :: repo_path(*)
    end function c_g4s_init

    integer(c_int) function c_g4s_deeppot_load(frozen_npz) &
        bind(c, name="g4s_deeppot_load")
      import :: c_char, c_int
      character(kind=c_char), intent(in) :: frozen_npz(*)
    end function c_g4s_deeppot_load

    integer(c_int) function g4s_deeppot_eval(handle, natoms, coord, box, &
        types, energy, force, virial) bind(c, name="g4s_deeppot_eval")
      import :: c_int, c_double
      integer(c_int), value :: handle, natoms
      real(c_double), intent(in) :: coord(*), box(*)
      integer(c_int), intent(in) :: types(*)
      real(c_double), intent(out) :: energy, force(*), virial(*)
    end function g4s_deeppot_eval

    integer(c_int) function c_g4s_ignition_delay(mech_yaml, phase, t0, &
        p0, tau) bind(c, name="g4s_ignition_delay")
      import :: c_char, c_int, c_double
      character(kind=c_char), intent(in) :: mech_yaml(*), phase(*)
      real(c_double), value :: t0, p0
      real(c_double), intent(out) :: tau
    end function c_g4s_ignition_delay

    subroutine g4s_finalize() bind(c, name="g4s_finalize")
    end subroutine g4s_finalize
  end interface

contains

  function g4s_init(repo_path) result(rc)
    character(len=*), intent(in) :: repo_path
    integer(c_int) :: rc
    rc = c_g4s_init(trim(repo_path)//c_null_char)
  end function g4s_init

  function g4s_deeppot_load(frozen_npz) result(handle)
    character(len=*), intent(in) :: frozen_npz
    integer(c_int) :: handle
    handle = c_g4s_deeppot_load(trim(frozen_npz)//c_null_char)
  end function g4s_deeppot_load

  function g4s_ignition_delay(mech_yaml, phase, t0, p0, tau) result(rc)
    character(len=*), intent(in) :: mech_yaml, phase
    real(c_double), intent(in) :: t0, p0
    real(c_double), intent(out) :: tau
    integer(c_int) :: rc
    rc = c_g4s_ignition_delay(trim(mech_yaml)//c_null_char, &
                              trim(phase)//c_null_char, t0, p0, tau)
  end function g4s_ignition_delay

end module g4s_capi
